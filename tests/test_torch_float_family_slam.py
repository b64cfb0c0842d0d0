"""The float-descriptor family end to end in the port: the host ``SLAM``
on DoG SIFT + L2 (tests/test_float_family_slam.py's world and
``sift_config``, as tests/facade_world.py gives them) beside the JAX
package's run of the same world, the float signatures, the float guided
match, and a float map crossing between the packages bit for bit. Both
runs pin one thread: the whole facade turns on float32 rounding (ROADMAP,
"ATE bands end to end"), so the runs are held by bands, not frame by
frame."""
import numpy as np
import torch

import facade_world as fw
from render import render_sequence

torch.set_num_threads(1)


def _run(SLAM, PinholeCamera, Config, ate_rmse, **kw):
    frames, K, Ts_gt = fw.e2e_frames(10)
    cam = PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K)
    slam = SLAM(cam, fw.sift_config(Config), **kw)
    states = [slam.track([img], timestamp=i * fw.DT)["state"] for i, img in enumerate(frames)]
    slam.shutdown()
    boot = states.index("OK") if "OK" in states else len(states)
    res = {"states": states, "relocs": 0, "poses": [], "boot": boot, "secs_after_boot": 0.0}
    widths = {int(np.asarray(mp.descriptor).size) for mp in slam.map.get_map_points() if mp.descriptor is not None}
    return states, fw.summary(slam, res, Ts_gt, ate_rmse), widths


def test_sift_slam_e2e_against_jax():
    """Both packages initialize and track the 10-frame sprite sequence on
    128-word float blocks: OK on the last two frames, at least 3 keyframes
    and more than 50 landmarks, every landmark descriptor 128 wide; the
    port's keyframe ATE at most max(2 x JAX's, 2.0 %) of the path."""
    from visual_slam_tpu.camera import PinholeCamera as JCamera
    from visual_slam_tpu.config import Config as JConfig
    from visual_slam_tpu.slam import SLAM as JSLAM
    from visual_slam_tpu.utils.metrics import ate_rmse as jate
    from visual_slam_tpu_torch.camera import PinholeCamera
    from visual_slam_tpu_torch.config import Config
    from visual_slam_tpu_torch.slam import SLAM
    from visual_slam_tpu_torch.utils.metrics import ate_rmse

    runs = {"jax": _run(JSLAM, JCamera, JConfig, jate), "torch": _run(SLAM, PinholeCamera, Config, ate_rmse,
                                                                      device="cpu")}
    for name, (states, s, widths) in runs.items():
        assert states[-1] == "OK" and states[-2] == "OK", (name, states)
        assert s["keyframes"] >= 3 and s["landmarks"] > 50, (name, s)
        assert widths == {128}, (name, widths)
    pct = {name: r[1]["ate_keyframes"]["pct"] for name, r in runs.items()}
    assert pct["torch"] <= max(2 * pct["jax"], 2.0), pct


def test_float_signature_discriminates():
    """Mirror of test_float_family_slam.py: a keyframe's float signature
    scores itself above a different view."""
    from visual_slam_tpu_torch.frontend import feature_factory
    from visual_slam_tpu_torch.loop_closing.signature import keyframe_signature, score_signatures

    frames, _, _, _ = render_sequence(np.random.default_rng(7), n_frames=6, step=0.8)
    det = feature_factory("sift", num_features=256, n_octaves=3, device="cpu")
    sigs = np.stack([keyframe_signature(f.desc, f.valid).numpy()
                     for f in (det.detectAndCompute(frames[i]) for i in (0, 1, 5))])
    scores = score_signatures(sigs[0], sigs)
    assert np.argmax(scores) == 0 and scores[0] > scores[2]


def test_float_guided_match_roundtrip():
    """Mirror of test_float_family_slam.py: landmarks projected at their
    true pixels match their own float descriptors under L2."""
    from visual_slam_tpu_torch.ops.guided_matching import guided_match

    from test_torch_float_ops import _guided_inputs

    pts, desc, K, uv = _guided_inputs()
    M = len(pts)
    d = torch.from_numpy(desc.view(np.int32))
    res = guided_match(torch.from_numpy(pts), d, torch.ones(M, dtype=torch.bool), torch.eye(4), torch.from_numpy(K),
                       torch.from_numpy(uv), d, torch.ones(M, dtype=torch.bool), 160.0, 120.0, radius_px=5.0)
    ok, lm = res["valid"].numpy(), res["lm_idx"].numpy()
    assert ok.sum() > M * 0.9
    assert (lm[ok] == np.nonzero(ok)[0]).mean() > 0.95


def test_float_map_crosses_both_packages(tmp_path):
    """A map with 128-word float descriptors (f32 bitcast) crosses between
    the packages bit for bit: through ``interop.map_from_numpy``, and saved
    by either package and loaded by the other (tests/test_torch_serialization.py's
    checks, on float blocks)."""
    import jax.numpy as jnp

    from test_torch_serialization import _assert_same_map, _pose
    from visual_slam_tpu import map as jmap
    from visual_slam_tpu.ops.detector import Features as JFeatures
    from visual_slam_tpu.utils import serialization as jser
    from visual_slam_tpu_torch import interop
    from visual_slam_tpu_torch.utils import serialization as tser

    rng = np.random.default_rng(9)

    def unit_rows(n):
        d = rng.normal(size=(n, 128)).astype(np.float32)
        return (d / np.linalg.norm(d, axis=1, keepdims=True)).view(np.uint32)

    m = jmap.Map()
    kfs = []
    for r in range(2):
        f = dict(xy=rng.uniform(0, 320, (32, 2)).astype(np.float32),
                 response=rng.uniform(0, 1, 32).astype(np.float32),
                 angle=rng.uniform(-np.pi, np.pi, 32).astype(np.float32),
                 octave=rng.integers(0, 3, 32).astype(np.int32), size=rng.uniform(3, 20, 32).astype(np.float32),
                 desc=unit_rows(32), valid=rng.uniform(size=32) < 0.9)
        kf = jmap.KeyFrame(features=[JFeatures(**{k: jnp.asarray(v) for k, v in f.items()})], timestamp=0.1 * r)
        kf.update_pose(_pose(rng))
        m.add_keyframe(kf)
        kfs.append(kf)
    for i, desc in enumerate(unit_rows(12)):
        mp = jmap.MapPoint(rng.normal(0, 5, 3), color=rng.integers(0, 256, 3).astype(np.uint8), descriptor=desc)
        m.add_map_point(mp)
        kfs[i % 2].add_map_point(0, i, mp)
    port = interop.map_from_numpy(m.get_keyframes(), m.get_map_points(), device="cpu")
    _assert_same_map(m, port)
    assert port.get_keyframes()[0].get_features(0).desc.shape == (32, 128)
    jser.save_map(m, tmp_path / "jax.npz")
    tser.save_map(port, tmp_path / "port.npz")
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)
        assert zt["mp_descs"].shape == (12, 128) and zt["mp_descs"].dtype == np.uint32
    _assert_same_map(port, tser.load_map(tmp_path / "jax.npz", device="cpu"))
    _assert_same_map(m, jser.load_map(tmp_path / "port.npz"))
