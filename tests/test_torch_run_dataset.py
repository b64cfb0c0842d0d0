"""The port's dataset entry points (``examples/run_dataset_torch.py``,
``examples/visual_odometry_demo_torch.py``) against the JAX package's
(``examples/run_dataset.py``, ``examples/visual_odometry_demo.py``).

The dataset is a 320x240 ``render_sequence`` world written as 8-bit PNG
files in the KITTI layout by ``tests/dataset_world.py`` (numpy + zlib),
read through each package's native loader at 512 features and 2 levels.
The worlds are chaotic (a near-tie descriptor bit or a float32 rounding
changes a keyframe), so the two packages are held to a band, as
tests/test_torch_adam.py holds its SLAM run: each ends OK with at least 2
keyframes, and the port's keyframe ATE is at most max(1.5 x JAX's, JAX's +
0.1 world units). Within the port, reading
the PNG files through the native loader and feeding the same uint8 frames
from memory are the same run, exactly (one torch thread pinned inside
each run).

The ``cuda`` case runs the native and the in-memory run on the card
(``python -m pytest --noconftest -m cuda tests/test_torch_run_dataset.py``;
JAX is imported only in the fixtures that run the JAX package).
"""
import contextlib
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dataset_world as dw
from visual_slam_tpu_torch.io.source import DataSourceBase
from visual_slam_tpu_torch.processing import Processing
from visual_slam_tpu_torch.utils.metrics import ate_rmse

ROOT = Path(__file__).resolve().parents[1]
FPS = 30.0  # Config().camera.fps: the timestamp of frame i is i / FPS
EXPORTS = ("trajectory_tum.txt", "trajectory_kitti.txt", "map.npz", "map.ply")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _threads(n: int):
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@contextlib.contextmanager
def _argv(argv):
    prev = sys.argv
    sys.argv = argv
    try:
        yield
    finally:
        sys.argv = prev


class MemorySource(DataSourceBase):
    """The uint8 frames from memory, with the native loader's timestamps."""

    def __init__(self, frames, fps: float = FPS):
        self.frames, self.fps, self.i = frames, fps, 0

    def get_frame(self):
        if self.i >= len(self.frames):
            return None, 0.0
        self.i += 1
        return self.frames[self.i - 1], (self.i - 1) / self.fps

    def is_ok(self):
        return self.i < len(self.frames)

    def num_frames(self):
        return len(self.frames)

    def get_frame_shape(self):
        return self.frames[0].shape[:2]


def _npz_layout(z) -> dict:
    """A ``map.npz``'s keys with their dtypes and trailing shapes: the
    keyframe rows' blocks (``kf<row>_<field>``) by field, the rows, the rest
    by key."""
    keys, block, rows = {}, {}, set()
    for k in z.files:
        m = re.fullmatch(r"kf(\d+)_(\w+)", k)
        if m:
            rows.add(int(m.group(1)))
            block.setdefault(m.group(2), set()).add((str(z[k].dtype), z[k].shape[1:]))
        else:
            keys[k] = (str(z[k].dtype), z[k].shape[1:])
    return {"keys": keys, "block": block, "rows": sorted(rows)}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("small_world")
    images, calib, u8, K, Ts = dw.small_dataset(root)
    return {"root": root, "images": images, "calib": calib, "u8": u8, "K": K, "Ts": Ts}


def _port_run(ds, out_dir, device="cpu"):
    rd = _load("run_dataset_torch")
    argv = [str(ds["images"]), str(ds["calib"]), "--native-loader", *dw.SMALL_ARGS, "--out-dir", str(out_dir)]
    if device == "cpu":
        argv.append("--cpu")
    with _threads(1):
        return rd.main(argv)


def _memory_run(ds, device="cpu"):
    rd = _load("run_dataset_torch")
    cfg = rd.make_config(rd.parse_args([str(ds["images"]), *dw.SMALL_ARGS]))
    states = []
    with _threads(1):
        proc = Processing(MemorySource(ds["u8"]), ds["calib"], cfg, device=device)
        result = proc.run(on_frame=lambda i, info: states.append(info["state"]))
    return result, states, proc.slam


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
    """The JAX package's ``run_dataset.main`` and the port's, each with the
    native loader, on the same PNG directory."""
    jax_out = tmp_path_factory.mktemp("jax_out")
    port_out = tmp_path_factory.mktemp("port_out")
    argv = ["run_dataset.py", str(dataset["images"]), str(dataset["calib"]), "--native-loader", *dw.SMALL_ARGS,
            "--cpu", "--out-dir", str(jax_out)]
    with _argv(argv):
        _load("run_dataset").main()
    return {"jax": jax_out, "port": _port_run(dataset, port_out), "port_out": port_out}


def test_both_packages_track_the_png_world(dataset, runs):
    port = runs["port"]
    assert port["state"] == "OK" and port["frames"] == dw.SMALL_FRAMES
    assert "LOST" not in port["states"]
    assert port["keyframes"] >= 2
    jax_tum = np.loadtxt(runs["jax"] / "trajectory_tum.txt").reshape(-1, 8)
    assert len(jax_tum) >= 2
    ours = dw.tum_ate(ate_rmse, runs["port_out"] / "trajectory_tum.txt", dataset["Ts"], FPS)
    theirs = dw.tum_ate(ate_rmse, runs["jax"] / "trajectory_tum.txt", dataset["Ts"], FPS)
    assert ours["n"] == port["keyframes"]
    assert ours["m"] <= max(1.5 * theirs["m"], theirs["m"] + 0.1), (ours, theirs)


def test_exports_have_the_jax_files_keys_and_dtypes(runs):
    port_files = {k: Path(v) for k, v in runs["port"]["exports"].items()}
    assert sorted(port_files) == sorted(EXPORTS)
    assert sorted(p.name for p in runs["port_out"].iterdir()) == sorted(p.name for p in runs["jax"].iterdir())
    ours, theirs = _npz_layout(np.load(port_files["map.npz"])), _npz_layout(np.load(runs["jax"] / "map.npz"))
    assert ours["keys"] == theirs["keys"] and ours["block"] == theirs["block"]
    assert ours["rows"] == list(range(runs["port"]["keyframes"]))
    n_kf = runs["port"]["keyframes"]
    for name, cols in (("trajectory_tum.txt", 8), ("trajectory_kitti.txt", 12)):
        a = np.loadtxt(port_files[name]).reshape(-1, cols)
        assert len(a) == n_kf
        assert len(np.loadtxt(runs["jax"] / name).reshape(-1, cols)) == len(theirs["rows"])
    ply = [p.read_text().splitlines() for p in (port_files["map.ply"], runs["jax"] / "map.ply")]
    assert [re.sub(r"\d+$", "N", line) for line in ply[0][:10]] == [re.sub(r"\d+$", "N", line) for line in ply[1][:10]]
    good = sum(not mp.is_bad for mp in runs["port"]["slam"].map.get_map_points())
    assert ply[0][2] == f"element vertex {good}" and len(ply[0]) == 10 + good


def test_exports_hold_the_keyframe_poses(runs):
    from visual_slam_tpu_torch.utils.serialization import load_map, load_trajectory_tum

    kfs = runs["port"]["slam"].map.get_keyframes()
    T_w2c = np.stack([kf.T_w2c for kf in kfs])
    ts, T_c2w = load_trajectory_tum(runs["port_out"] / "trajectory_tum.txt")
    np.testing.assert_allclose(ts, [kf.timestamp for kf in kfs], atol=1e-6)
    np.testing.assert_allclose(T_c2w, np.linalg.inv(T_w2c), atol=1e-5)
    kitti = np.loadtxt(runs["port_out"] / "trajectory_kitti.txt").reshape(-1, 3, 4)
    np.testing.assert_allclose(kitti, np.linalg.inv(T_w2c)[:, :3], atol=1e-5)
    m = load_map(runs["port_out"] / "map.npz", device="cpu")
    np.testing.assert_array_equal(np.stack([kf.T_w2c for kf in m.get_keyframes()]), T_w2c)


def test_native_run_equals_the_in_memory_run(dataset, runs):
    """The PNG files through the native loader and the same uint8 frames
    from memory give the same run: states, counts and keyframe poses."""
    port = runs["port"]
    result, states, slam = _memory_run(dataset)
    assert states == port["states"]
    assert (result["keyframes"], result["map_points"]) == (port["keyframes"], port["map_points"])
    a = np.stack([kf.T_w2c for kf in port["slam"].map.get_keyframes()])
    b = np.stack([kf.T_w2c for kf in slam.map.get_keyframes()])
    np.testing.assert_array_equal(a, b)


def test_demo_against_the_jax_demo(capsys):
    """The port's demo (``main(["--cpu"])``) and the JAX package's on the
    same rendered world: each tracks it, the ATEs within the band."""
    with _argv(["visual_odometry_demo.py", "--cpu"]):
        _load("visual_odometry_demo").main()
    out = capsys.readouterr().out
    theirs = float(re.search(r"ATE RMSE \(Sim3-aligned\): ([0-9.]+)", out).group(1))
    with _threads(1):
        ours = _load("visual_odometry_demo_torch").main(["--cpu"])
    assert ours["states"][-1] == "OK" and "LOST" not in ours["states"]
    assert ours["keyframes"] >= 2
    assert ours["ate"]["rmse"] <= max(1.5 * theirs, theirs + 0.1), (ours["ate"], theirs)
    assert ours["timing"]["track"]["n"] == len(ours["states"]) == 20


@pytest.mark.cuda
def test_native_run_on_the_card_equals_its_in_memory_run(dataset, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's default device)")
    port = _port_run(dataset, tmp_path, device=None)
    result, states, slam = _memory_run(dataset, device="cuda")
    assert port["state"] == "OK" and "LOST" not in port["states"]
    assert states == port["states"]
    a = np.stack([kf.T_w2c for kf in port["slam"].map.get_keyframes()])
    b = np.stack([kf.T_w2c for kf in slam.map.get_keyframes()])
    np.testing.assert_array_equal(a, b)
