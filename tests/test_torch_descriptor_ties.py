"""Where the port's descriptors differ from the JAX package's on the small
ring (tests/loop_pipeline_world.py, ROADMAP queue 3, Q3.4): only at near
ties of the steered-BRIEF comparisons.

On the ring's frames 20-22 (the stretch before the port's LOST frame 24 of
Q3.4) both detectors give the same keypoints, and their descriptors differ
on about 2 % of the bits. Every differing bit is a comparison whose two
samples, computed in float64 from the same blurred level, lie within 1e-3
grey levels of each other (flat sprite interiors, where a float32 sum's
order decides the bit); no comparison with a wider margin differs, in
either package, from the float64 bit. The thread count of the CPU matmul
moves the same ties (run at 2 threads, where Q3.4's port runs lose the
ring)."""
import contextlib

import numpy as np
import pytest
import torch

import loop_pipeline_world as lpw
from visual_slam_tpu_torch.ops import detector as tdet
from visual_slam_tpu_torch.ops import orb
from visual_slam_tpu_torch.ops import pyramid as pyr

CFG = dict(num_features=320, threshold=12.0, n_levels=2, scale=1.2, grid=4, edge_margin=16)
MARGIN = 1e-3


@contextlib.contextmanager
def _threads(n: int):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _bits(desc, n):
    d = np.ascontiguousarray(np.asarray(desc)[:n]).view(np.uint32)
    return ((d[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(n, 256).astype(bool)


def _float64_bits(img: torch.Tensor, yx: np.ndarray):
    """Level-0 steered-BRIEF bits and comparison margins in float64 at the
    keypoints ``yx`` (clamped 31x31 windows, as K1)."""
    H, W = img.shape
    r = np.arange(-orb.RADIUS, orb.RADIUS + 1)
    ys = np.clip(yx[:, 0][:, None] + r[None], 0, H - 1)
    xs = np.clip(yx[:, 1][:, None] + r[None], 0, W - 1)
    blur = pyr.gaussian_blur(img.double(), 2.0, 3).numpy()
    patches = blur[ys[:, :, None], xs[:, None, :]].reshape(len(yx), -1)
    raw = img.double().numpy()[ys[:, :, None], xs[:, None, :]].reshape(len(yx), -1)
    m = raw @ orb.MOMENT_W_NP.astype(np.float64)
    ang = np.arctan2(m[:, 1], m[:, 0])
    bins = np.floor(np.mod(ang, 2 * np.pi) / (2 * np.pi) * orb.N_BINS).astype(int) % orb.N_BINS
    samples = (patches @ orb.sampling_matrix_np().astype(np.float64)).reshape(len(yx), orb.N_BINS, -1)
    vals = samples[np.arange(len(yx)), bins].reshape(len(yx), orb.N_BITS, 2)
    return vals[..., 0] < vals[..., 1], np.abs(vals[..., 0] - vals[..., 1])


@pytest.mark.parametrize("frame", [20, 21, 22])
def test_descriptors_differ_only_at_near_ties(frame):
    import jax
    import jax.numpy as jnp

    from visual_slam_tpu.ops import detector as jdet

    frames, _, _ = lpw.small_ring_frames()
    img = torch.from_numpy(np.asarray(frames[frame], np.float32))
    fj = jax.device_get(jdet.detect_and_describe(jnp.asarray(frames[frame], jnp.float32), **CFG))
    with _threads(2):
        ft = tdet.detect_and_describe(img, torch.from_numpy(orb.sampling_matrix_np().copy()),
                                      torch.from_numpy(orb.MOMENT_W_NP), **CFG)
    np.testing.assert_array_equal(ft.xy.numpy(), np.asarray(fj.xy))
    k0 = tdet.level_quotas(CFG["num_features"], CFG["n_levels"], CFG["scale"])[0]
    yx, _, valid, _ = tdet.detect_level(img, k0, CFG["threshold"], CFG["grid"], CFG["edge_margin"])
    truth, margin = _float64_bits(img, yx.numpy())
    v = valid.numpy()[:, None]
    bj, bt = _bits(fj.desc, k0), _bits(ft.desc.numpy().view(np.uint32), k0)
    differ = (bj != bt) & v
    share = differ.sum() / (v.sum() * orb.N_BITS)
    assert 0.005 < share < 0.05, share  # the ~2 % of bits Q3.4 is about
    assert margin[differ].max() <= MARGIN
    wide = (margin > MARGIN) & v
    assert not ((bj != truth) & wide).any() and not ((bt != truth) & wide).any()
