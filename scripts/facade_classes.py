#!/usr/bin/env python3
"""Class and compare facade runs of two packages from
``scripts/facade_reference.py``'s JSON lines.

    python scripts/facade_classes.py jax.jsonl torch.jsonl [card.jsonl ...]

Each run is clean, LOST (a LOST frame after the bootstrap, or a final state
other than OK) or a scale jump (keyframe ATE above ``--jump-pct``, 5 % of
the path by default). For each file: the runs by class, the failed count
and the median keyframe ATE of the clean runs. Each later file is held to
the first (the reference): a one-sided Fisher exact test that it fails more
often (``scipy.stats.fisher_exact``, p < ``--alpha``), and its clean median
against max(2 x the reference's, ``--median-floor`` %). Prints one JSON
line per file and a verdict line per comparison.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys


def classify(run: dict, jump_pct: float) -> str:
    if run.get("lost_after_boot") or run.get("state") != "OK":
        return "LOST"
    pct = run.get("ate_keyframes", {}).get("pct", float("inf"))
    return "scale jump" if pct > jump_pct else "clean"


def summarize(path: str, jump_pct: float) -> dict:
    runs = [json.loads(line) for line in open(path) if line.strip().startswith("{")]
    classes = [classify(r, jump_pct) for r in runs]
    clean = [r["ate_keyframes"]["pct"] for r, c in zip(runs, classes) if c == "clean"]
    return {"file": path, "impl": runs[0].get("impl") if runs else None, "runs": len(runs),
            "clean": classes.count("clean"), "lost": classes.count("LOST"),
            "scale_jump": classes.count("scale jump"), "failed": len(runs) - classes.count("clean"),
            "clean_median_pct": statistics.median(clean) if clean else None,
            "clean_pct": sorted(clean),
            "by_run": [(r.get("ransac_seed"), r.get("perturb"), c,
                        r.get("ate_keyframes", {}).get("pct")) for r, c in zip(runs, classes)]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("files", nargs="+", help="the reference's JSON lines first, then the runs held to it")
    ap.add_argument("--jump-pct", type=float, default=5.0)
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--median-floor", type=float, default=2.0)
    args = ap.parse_args()
    from scipy.stats import fisher_exact

    ref, *others = [summarize(f, args.jump_pct) for f in args.files]
    for s in (ref, *others):
        print(json.dumps(s))
    for s in others:
        table = [[s["failed"], s["clean"]], [ref["failed"], ref["clean"]]]
        p = float(fisher_exact(table, alternative="greater").pvalue)
        median_gate = max(2 * ref["clean_median_pct"], args.median_floor)
        more_failures = p < args.alpha
        median_high = s["clean_median_pct"] is None or s["clean_median_pct"] > median_gate
        print(json.dumps({"file": s["file"], "reference": ref["file"], "failed": [s["failed"], s["runs"]],
                          "reference_failed": [ref["failed"], ref["runs"]], "fisher_p_more_failures": p,
                          "clean_median_pct": s["clean_median_pct"], "median_gate_pct": median_gate,
                          "verdict": "fault" if more_failures or median_high else "not a fault"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
