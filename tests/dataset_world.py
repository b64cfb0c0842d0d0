"""Image-directory datasets on disk for the dataset entry points (numpy,
``zlib`` and ``struct`` only: no image library).

Shared by ``chip_smoke.py``'s dataset phase and the port's CPU tests, so
both write the same files:

* ``write_png``: an 8-bit grayscale PNG (one IDAT, filter 0 on each row);
* ``write_kitti``: a KITTI odometry layout (``image_0/000000.png``, ...,
  ``calib.txt`` with P0 from K) of frames rounded and clipped to uint8;
* ``deploy_dataset``: the deploy world's first frames (376x1240,
  ``facade_world.deploy_frames``);
* ``small_dataset``: a 320x240 ``render.render_sequence`` world (the
  demo's), read at 512 features and 2 levels (``SMALL_ARGS``);
* ``tum_ate``: the scale-aligned keyframe ATE of a TUM trajectory file.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SMALL_FRAMES = 16
SMALL_FEATURES_LEVELS = (512, 2)
SMALL_ARGS = ["--features", str(SMALL_FEATURES_LEVELS[0]), "--levels", str(SMALL_FEATURES_LEVELS[1])]


def to_uint8(frames) -> np.ndarray:
    """Frames rounded to the nearest integer and clipped to 0-255."""
    return np.clip(np.rint(np.asarray(frames, np.float64)), 0, 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path: str | Path, img: np.ndarray) -> None:
    """Write an (H, W) uint8 array as an 8-bit grayscale PNG."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"write_png takes (H, W) uint8; got {img.dtype} {img.shape}")
    h, w = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)  # filter byte 0 (none) per row
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
    Path(path).write_bytes(data + _chunk(b"IEND", b""))


def write_kitti(root: str | Path, frames, K) -> tuple[Path, Path, np.ndarray]:
    """Write ``frames`` (rounded and clipped to uint8) as
    ``root/image_0/%06d.png`` and K as P0 of ``root/calib.txt``. Returns
    (image directory, calibration file, the uint8 frames)."""
    root = Path(root)
    images = root / "image_0"
    images.mkdir(parents=True, exist_ok=True)
    u8 = to_uint8(frames)
    for i, img in enumerate(u8):
        write_png(images / f"{i:06d}.png", img)
    calib = root / "calib.txt"
    calib.write_text(f"P0: {K[0, 0]} 0 {K[0, 2]} 0 0 {K[1, 1]} {K[1, 2]} 0 0 0 1 0\n")
    return images, calib, u8


def deploy_dataset(root: str | Path, n_frames: int = 32):
    """The deploy world's first ``n_frames`` frames on disk: (image
    directory, calibration file, uint8 frames, K, T_w2c ground truth)."""
    import facade_world as fw

    frames, K, Ts = fw.deploy_frames(n_frames)
    images, calib, u8 = write_kitti(root, frames, K)
    return images, calib, u8, K, Ts


def small_frames(n_frames: int = SMALL_FRAMES, seed: int = 0):
    """(frames rounded and clipped to 0-255 as float32, K, T_w2c ground
    truth) of the 320x240 ``render_sequence`` world, as its PNG files hold
    it."""
    from render import render_sequence

    frames, Ts, K, _ = render_sequence(np.random.default_rng(seed), n_frames=n_frames, step=0.3)
    return to_uint8(frames).astype(np.float32), K, np.stack(Ts)


def small_dataset(root: str | Path, n_frames: int = SMALL_FRAMES, seed: int = 0):
    """The 320x240 ``render_sequence`` world on disk: (image directory,
    calibration file, uint8 frames, K, T_w2c ground truth)."""
    frames, K, Ts = small_frames(n_frames, seed)
    images, calib, u8 = write_kitti(root, frames, K)
    return images, calib, u8, K, Ts


def tum_ate(ate_rmse, tum_path: str | Path, Ts_gt, fps: float) -> dict:
    """``facade_world.ate`` of a TUM trajectory file (``timestamp tx ty tz
    qx qy qz qw``, camera to world) written at ``fps`` frames a second."""
    import facade_world as fw

    from visual_slam_tpu_torch.utils.serialization import load_trajectory_tum

    ts, T_c2w = load_trajectory_tum(tum_path)
    return fw.ate(ate_rmse, ts, np.linalg.inv(T_c2w), Ts_gt, dt=1.0 / fps)
