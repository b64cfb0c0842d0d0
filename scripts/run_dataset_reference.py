#!/usr/bin/env python3
"""The JAX package's ``examples/run_dataset.py`` on the CPU over the PNG
worlds of ``chip_smoke.py``'s dataset phase (``tests/dataset_world.py``),
with the phase's flags and ``--cpu``: the reference its gates are set from
(``RD_JAX``, ``RD_SMALL_JAX``). Prints one JSON line per world.

    python scripts/run_dataset_reference.py --world deploy small --out /tmp/rd_reference
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

FPS = 30.0  # Config().camera.fps: the loader's timestamp of frame i is i / FPS


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", nargs="+", choices=("deploy", "small"), default=["deploy", "small"])
    ap.add_argument("--out", required=True, help="a directory for the PNG files and the exports")
    args = ap.parse_args()

    import dataset_world as dsw

    from visual_slam_tpu_torch.utils.metrics import ate_rmse

    for world in args.world:
        root = Path(args.out) / world
        if world == "deploy":
            images, calib, _, _, Ts = dsw.deploy_dataset(root / "seq")
            flags = ["--levels", "4", "--frames", "32"]
        else:
            images, calib, _, _, Ts = dsw.small_dataset(root / "seq")
            flags = dsw.SMALL_ARGS
        out = root / "out"
        cmd = [sys.executable, str(ROOT / "examples" / "run_dataset.py"), str(images), str(calib), "--native-loader",
               *flags, "--cpu", "--out-dir", str(out)]
        res = subprocess.run(cmd, capture_output=True, text=True, check=True)
        result = next(line for line in res.stdout.splitlines() if line.startswith("{"))
        print(json.dumps({"world": world, "flags": flags, "result": result,
                          "ate_keyframes": dsw.tum_ate(ate_rmse, out / "trajectory_tum.txt", Ts, FPS)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
