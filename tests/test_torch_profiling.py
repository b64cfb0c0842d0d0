"""The port's profiling module (``visual_slam_tpu_torch.utils.profiling``)
against the JAX package's: ``StageTimer``'s statistics, ``flops_of`` on a
product, ``mfu``'s formula, and ``device_trace`` on the CPU."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_slam_tpu.utils import profiling as jprof
from visual_slam_tpu_torch.utils import profiling as prof


def test_stage_timer_stats_equal_the_jax_timers():
    samples = np.random.default_rng(3).exponential(0.02, 57)
    ours, theirs = prof.StageTimer(), jprof.StageTimer()
    for i, s in enumerate(samples):
        for t in (ours, theirs):
            t.add("detect" if i % 3 else "match", float(s))
    assert ours.summary() == theirs.summary()
    assert ours.stats("missing") == theirs.stats("missing") == {}
    assert ours.report() == theirs.report()
    with ours("block"):
        pass
    assert ours.stats("block")["n"] == 1 and ours.stats("block")["total_s"] >= 0.0
    ours.reset()
    assert ours.summary() == {}
    assert isinstance(prof.GLOBAL_TIMER, prof.StageTimer)


def test_flops_of_a_product_equals_jax_and_2mnk():
    M, K, N = 64, 128, 32
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((M, K), np.float32), rng.standard_normal((K, N), np.float32)
    ours = prof.flops_of(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    theirs = jprof.flops_of(jax.jit(jnp.matmul), jnp.asarray(a), jnp.asarray(b))
    assert ours == theirs == 2 * M * N * K


def test_flops_of_without_a_product_is_none():
    """Elementwise work has no count in the port (aten's formulas cover
    products only), so the answer is None, as JAX's without a cost model."""
    x = torch.ones(16)
    assert prof.flops_of(torch.add, x, x) is None
    assert prof.flops_of(lambda v, *, scale: v * scale, x, scale=2.0) is None


@pytest.mark.parametrize("flops,seconds", [(2.0e12, 0.5), (67e12, 1.0), (None, 1.0), (1e9, 0.0)])
def test_mfu_formula(flops, seconds):
    got = prof.mfu(flops, seconds)
    if flops is None or seconds <= 0:
        assert got is None
        return
    assert got == pytest.approx(100.0 * flops / seconds / 67e12)
    assert prof.mfu(flops, seconds, peak_flops=197e12) == jprof.mfu(flops, seconds, peak_flops=197e12)
    assert prof.H100_FP32_PEAK_FLOPS == 67e12


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.randn(32, 32)
    with prof.device_trace(tmp_path / "trace") as p:
        with torch.profiler.record_function("vslam_span"):
            (x @ x).sum()
    assert p is not None
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    text = files[0].read_text()
    assert "vslam_span" in text and "aten::mm" in text
    assert "traceEvents" in json.loads(text)
