"""Tracing and profiling (port of ``visual_slam_tpu.utils.profiling``).

Per-stage wall-clock timers with summary statistics (``StageTimer``,
``GLOBAL_TIMER``), a ``torch.profiler`` trace context for device-level
inspection (``device_trace``), and FLOP / MFU accounting (``flops_of``,
``mfu``).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import numpy as np


class StageTimer:
    """Accumulates per-stage wall-clock samples.

    Usage::

        timer = StageTimer()
        with timer("detect"):
            ...
        print(timer.summary())
    """

    def __init__(self):
        self._samples: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[stage].append(time.perf_counter() - t0)

    def add(self, stage: str, seconds: float) -> None:
        self._samples[stage].append(seconds)

    def stats(self, stage: str) -> dict:
        xs = np.asarray(self._samples.get(stage, []))
        if xs.size == 0:
            return {}
        return {
            "n": int(xs.size),
            "mean_ms": float(xs.mean() * 1e3),
            "median_ms": float(np.median(xs) * 1e3),
            "p90_ms": float(np.quantile(xs, 0.9) * 1e3),
            "total_s": float(xs.sum()),
        }

    def summary(self) -> dict:
        return {k: self.stats(k) for k in sorted(self._samples)}

    def report(self) -> str:
        lines = [f"{'stage':<24}{'n':>6}{'mean ms':>10}{'p50 ms':>10}{'p90 ms':>10}{'total s':>10}"]
        for k, s in self.summary().items():
            lines.append(
                f"{k:<24}{s['n']:>6}{s['mean_ms']:>10.2f}{s['median_ms']:>10.2f}"
                f"{s['p90_ms']:>10.2f}{s['total_s']:>10.2f}"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self._samples.clear()


@contextlib.contextmanager
def device_trace(log_dir: str | Path):
    """``torch.profiler`` over the block: the host's operators and, where a
    CUDA device exists, its kernels (those launched through ctypes, K1-K5,
    included). Writes a Chrome trace (``chrome://tracing``, Perfetto) into
    ``log_dir`` on exit; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"))


# The yardstick of the port's MFU: the H100 SXM's dense fp32 peak, 67 TFLOP/s
# (NVIDIA H100 80GB HBM3 at 700 W). The port keeps TF32 off, so its products
# run at fp32 rate.
H100_FP32_PEAK_FLOPS = 67e12


def flops_of(fn, *args, **kwargs) -> float | None:
    """FLOPs of one call ``fn(*args, **kwargs)``, counted by running it once
    under ``torch.utils.flop_counter.FlopCounterMode``. Returns None when the
    count is 0.

    The count covers the products aten has a formula for (matrix products,
    convolutions, attention): 2 per multiply-add.
    It does not count elementwise work, as XLA's cost analysis does, nor the
    kernels launched through ctypes (K1-K5)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    f = float(counter.get_total_flops())
    return f if f > 0 else None


def mfu(flops: float | None, seconds: float,
        peak_flops: float = H100_FP32_PEAK_FLOPS) -> float | None:
    """Model-FLOP utilization (percent) of one call taking ``seconds``."""
    if flops is None or seconds <= 0:
        return None
    return 100.0 * flops / seconds / peak_flops


GLOBAL_TIMER = StageTimer()
