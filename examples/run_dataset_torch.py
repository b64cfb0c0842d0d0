"""Run the PyTorch port's SLAM pipeline on an image-directory dataset
(KITTI-style layout): the port's counterpart of ``examples/run_dataset.py``.

Usage:
  python examples/run_dataset_torch.py <image_dir> [calib_file] [--frames N]
    [--features N] [--levels N] [--native-loader] [--out-dir results/] [--cpu]

Runs on the CUDA card unless ``--cpu`` is given (without a card and without
``--cpu`` it raises). ``--native-loader`` reads the images through the C++
loader (``native/loader.cpp``, built on first use), which decodes PNG, PGM,
PPM and BMP in background threads without OpenCV or PIL. Writes
``trajectory_tum.txt``, ``trajectory_kitti.txt``, ``map.npz`` (the JAX
package's format) and ``map.ply`` into ``--out-dir``.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from visual_slam_tpu_torch.config import Config  # noqa: E402
from visual_slam_tpu_torch.processing import Processing  # noqa: E402
from visual_slam_tpu_torch.utils.serialization import (  # noqa: E402
    save_map,
    save_trajectory_kitti,
    save_trajectory_tum,
)
from visual_slam_tpu_torch.viz import MapVisualizer  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("image_dir")
    ap.add_argument("calib", nargs="?", default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--features", type=int, default=2000)
    ap.add_argument("--native-loader", action="store_true")
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--levels", type=int, default=None, help="pyramid levels")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return ap.parse_args(argv)


def make_config(args: argparse.Namespace) -> Config:
    cfg = Config()
    cfg.feature.num_features = args.features
    if args.levels:
        cfg.feature.num_pyramid_levels = args.levels
    # Initialization inlier demand must scale with the feature budget (the
    # default 100 is tuned for 2000 features; at --features 256 it could
    # never be met and the system would sit in INITIALIZING forever).
    cfg.initialization.min_inliers = min(cfg.initialization.min_inliers, max(30, args.features // 8))
    return cfg


def main(argv=None) -> dict:
    """Run the dataset and export. Returns ``Processing.run()``'s result
    with each frame's state (``states``), the first OK frame
    (``boot_frame``), the frames per second after it (``fps_after_boot``),
    the native loader's failed decodes (``decode_errors``; None without it),
    the written files (``exports``) and the ``SLAM`` system (``slam``)."""
    args = parse_args(argv)
    cfg = make_config(args)

    source = args.image_dir
    if args.native_loader:
        from visual_slam_tpu_torch.io.native import NativeDatasetSource

        source = NativeDatasetSource(args.image_dir, fps=cfg.camera.fps)

    proc = Processing(source, args.calib, cfg, device="cpu" if args.cpu else None)
    states, done_at = [], []

    def on_frame(i, info):
        states.append(info["state"])
        done_at.append(time.perf_counter())

    result = proc.run(max_cycles=args.frames, on_frame=on_frame)
    decode_errors = proc.source.decode_errors() if args.native_loader else None
    proc.source.release()
    print(result)

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    kfs = proc.slam.map.get_keyframes()
    exports = {name: out / name for name in ("trajectory_tum.txt", "trajectory_kitti.txt", "map.npz", "map.ply")}
    save_trajectory_tum(kfs, exports["trajectory_tum.txt"])
    save_trajectory_kitti(kfs, exports["trajectory_kitti.txt"])
    save_map(proc.slam.map, exports["map.npz"])
    MapVisualizer().save_ply(proc.slam.map, exports["map.ply"])
    print(f"exported trajectory + map to {out}/")

    boot = next((i for i, s in enumerate(states) if s == "OK"), len(states))
    n_after = len(states) - boot - 1
    secs = done_at[-1] - done_at[boot] if n_after > 0 else 0.0
    return {**result, "states": states, "boot_frame": boot, "fps_after_boot": n_after / secs if secs > 0 else 0.0,
            "decode_errors": decode_errors, "exports": exports, "slam": proc.slam}


if __name__ == "__main__":
    main()
