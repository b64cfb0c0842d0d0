#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s time goes: cProfile of some of its phases, on the
card, one after another in one process.

    python3 scripts/smoke_phase_profile.py --phases multiseq stereo_step

builds the kernels as the script does, runs each named phase through
``chip_smoke``'s own function (``multiseq``: ``run_multiseq``, the batched
VO phase; ``stereo_step``: ``run_stereo_step``) and writes, per phase, the
80 costliest calls by cumulative time and the 40 by own time to
``chiprun_out/diag/<phase>.txt`` and ``<phase>_tot.txt``; prints each phase's
seconds and the card's name and power limit. cProfile slows Python-heavy
code (a phase takes about 1.4x its time in ``chip_smoke.py``), so read the
shares, not the seconds.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", nargs="+", default=["multiseq", "stereo_step"], choices=["multiseq", "stereo_step"])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "diag"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("smoke_phase_profile.py: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import numpy as np
    import render as render_mod

    import chip_smoke as cs
    from visual_slam_tpu_torch import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    _build.build(force=True)
    _build.lib()
    dev = torch.device("cuda")
    phases = {"multiseq": lambda: cs.run_multiseq(torch, np, dev, render_mod),
              "stereo_step": lambda: cs.run_stereo_step(torch, np, dev)}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name in args.phases:
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        phases[name]()
        prof.disable()
        print(f"{name}: {time.perf_counter() - t0:.1f} s under cProfile ({card})", flush=True)
        for suffix, key, n in (("", "cumulative", 80), ("_tot", "tottime", 40)):
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(n)
            (out / f"{name}{suffix}.txt").write_text(buf.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
