"""``scripts/facade_state_probe.py``'s per-stage comparison (``compare_stage``,
the ``stages`` mode's judge) on calls captured from the port on CPU tensors:
the same call, fed to the port's function on the CPU and to the JAX
package's, must read within the probe's own tolerances (``STAGE_TOL``) for
RANSAC-F (float64, well-posed draws), the robust LM solve and DLT
triangulation; and a capture whose output was altered must read outside
them. The JAX module attributes the probe swaps (the RANSAC sampler and the
null-vector route) are restored after each case.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import facade_state_probe as probe  # noqa: E402

from visual_slam_tpu_torch.backend import ba as tba  # noqa: E402
from visual_slam_tpu_torch.interop import ba_problem_from_numpy  # noqa: E402
from visual_slam_tpu_torch.ops import epipolar, triangulation  # noqa: E402

torch.set_num_threads(1)


def _two_view(rng, n=120):
    """Normalized and pixel coordinates of ``n`` points seen by two cameras
    0.4 m apart (K with f 500, centre (320, 240)), 0.3 px noise."""
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(6, 14, n)], 1)
    yaw = 0.05
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
    t = np.array([-0.4, 0.02, 0.05])
    n1 = pts[:, :2] / pts[:, 2:]
    p2 = pts @ R.T + t
    n2 = p2[:, :2] / p2[:, 2:]
    px = lambda x: (500.0 * x + [320.0, 240.0] + rng.normal(0, 0.3, x.shape)).astype(np.float32)  # noqa: E731
    return R, t, n1.astype(np.float32), n2.astype(np.float32), px(n1), px(n2)


def _capture(stage, rng):
    """(inputs, outputs) of one port call on CPU tensors, as the probe's
    ``StageLog`` keeps them."""
    if stage == "ransac_f":
        _, _, _, _, x1, x2 = _two_view(rng)
        mask = np.ones(len(x1), bool)
        idx = np.stack([rng.choice(len(x1), 8, replace=False) for _ in range(64)]).astype(np.int64)
        inputs = dict(x1=torch.from_numpy(x1), x2=torch.from_numpy(x2), mask=torch.from_numpy(mask),
                      sample_idx=torch.from_numpy(idx), thresh=1.0)
        out = epipolar.ransac_fundamental(inputs["x1"], inputs["x2"], inputs["mask"], None, n_hyp=64, thresh=1.0,
                                          sample_idx=inputs["sample_idx"])
        return inputs, dict(out)
    if stage == "ba_lm":
        from test_ba import make_ba_problem

        problem, _, _, f = make_ba_problem(rng, W=5, M=150, n_fixed=2)
        p = ba_problem_from_numpy(problem)
        kw = dict(n_iter=6, n_iter2=6, huber=5.0 / f, lam0=1e-3, trim_factor=3.0)
        T, X, info = tba.bundle_adjust_robust(p, **kw)
        return dict(p._asdict(), **kw), dict(T=T, X=X, cost0=info["cost0"], cost=info["cost"])
    R, t, n1, n2, _, _ = _two_view(rng)
    P1 = torch.eye(3, 4)
    P2 = torch.from_numpy(np.hstack([R, t[:, None]]).astype(np.float32))
    inputs = dict(P1=P1, P2=P2, x1=torch.from_numpy(n1), x2=torch.from_numpy(n2))
    pts, ok = triangulation.triangulate_dlt(P1, P2, inputs["x1"], inputs["x2"])
    return inputs, dict(pts=pts, ok=ok)


def _judged(res):
    return {name: r["ok"] for name, r in res.items() if "ok" in r}


@pytest.fixture
def restored(monkeypatch):
    """The probe's hooks to the port's unpatched functions, and the JAX
    module attributes it swaps, put back after the case."""
    from visual_slam_tpu.ops import epipolar as jepi
    from visual_slam_tpu.ops import pnp as jpnp

    for mod, name in ((jepi, "_sample_minimal_sets"), (jepi, "nullspace_vector"), (jpnp, "nullspace_vector")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    monkeypatch.setattr(probe, "_UNPATCHED", dict(rf=epipolar.ransac_fundamental, lm=tba.bundle_adjust_robust,
                                                  tri=triangulation.triangulate_dlt))


@pytest.mark.parametrize("stage", ["ransac_f", "ba_lm", "triangulate"])
def test_compare_stage_holds_a_port_call_to_jax(stage, restored):
    inputs, out = _capture(stage, np.random.default_rng(7))
    res = probe.compare_stage(stage, inputs, out, "cpu", None, None)
    judged = _judged(res)
    assert judged and all(judged.values()), res
    if stage == "ransac_f":
        assert set(judged) == {"run_f64_vs_jax", "cpu_f64_vs_jax"} and res["run_f64_vs_jax"]["draws"] == 64


@pytest.mark.parametrize("stage", ["ba_lm", "triangulate"])
def test_compare_stage_refuses_an_altered_call(stage, restored):
    inputs, out = _capture(stage, np.random.default_rng(7))
    if stage == "ba_lm":
        out["T"] = out["T"].clone()
        out["T"][3, 0, 3] += 1e-3  # a free pose moved past 1e-4
    else:
        out["pts"] = out["pts"] * 1.01  # every point 1 % off
    judged = _judged(probe.compare_stage(stage, inputs, out, "cpu", None, None))
    assert judged and not any(judged.values()), judged
