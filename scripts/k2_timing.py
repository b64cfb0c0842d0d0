#!/usr/bin/env python3
"""Device milliseconds of kernels K2 and K4 (``csrc/hamming_top2.cu``) of
one source tree, on the card, for an A/B of two trees in one call: run it
on the parent's tree and the change's in turns (parent, change, change,
parent), one process each, so each builds its own kernels.

    python3 scripts/k2_timing.py --root . --tag change
    python3 scripts/k2_timing.py --root PARENT_DIR --tag parent

where PARENT_DIR holds the parent commit's files (``git archive``).

K2 at 2000 x 2000 on ``chip_smoke.py``'s fixture (planted matches and ties,
about 10 % invalid queries and 5 % invalid trains: 1812 x 1912 valid pairs,
the main path's K2 row); K4 at 2000 queries against 64 candidate blocks of
2000, 8 real and 56 all-invalid padding (loop closing's detect). Each is
checked exact against its plain version, then timed with ``chip_smoke``'s
``device_ms`` (CUDA events over 200 back-to-back calls). Prints one JSON
line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="the source tree whose kernels are built and timed")
    ap.add_argument("--tag", required=True)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "tests")]

    import numpy as np
    import torch

    import chip_smoke as cs
    from visual_slam_tpu_torch import _build
    from visual_slam_tpu_torch.ops import match_kernels as mk

    if not torch.cuda.is_available():
        raise SystemExit("k2_timing.py: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.build(force=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    n = 2000
    d1, d2, v1, v2 = cs.hamming_fixture(np, rng, n)
    k2 = [torch.from_numpy(a).to(dev) for a in (d1.view(np.int32), d2.view(np.int32), v1, v2)]
    q = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    vq = rng.random(n) > 0.1
    blocks = rng.integers(0, 2**32, (64, n, 8), dtype=np.uint64).astype(np.uint32)
    vb = np.zeros((64, n), bool)
    for c in range(8):
        picked = rng.choice(n, 2 * n // 5, replace=False)
        blocks[c, :2 * n // 5] = q[picked] ^ (rng.random((2 * n // 5, 8)) < 0.05).astype(np.uint32)
        vb[c] = rng.random(n) > 0.1
    k4 = [torch.from_numpy(a).to(dev) for a in (q.view(np.int32), blocks.view(np.int32), vq, vb)]
    out = {"tag": args.tag, "card": card, "k2_valid_pairs": [int(v1.sum()), int(v2.sum())]}
    for name, fn, ref, a in (("k2", mk.hamming_top2, mk.hamming_top2_ref, k2),
                             ("k4", mk.hamming_top2_batched, mk.hamming_top2_batched_ref, k4)):
        got, want = fn(*a), ref(*a)
        torch.cuda.synchronize()
        out[f"{name}_exact"] = all(torch.equal(x, y) for x, y in zip(got, want))
        out[f"{name}_device_ms"], out[f"{name}_gapless"] = cs.device_ms(lambda: fn(*a))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
