"""The torch port imports without JAX."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

MODULES = [
    "visual_slam_tpu_torch",
    "visual_slam_tpu_torch._build",
    "visual_slam_tpu_torch.backend",
    "visual_slam_tpu_torch.backend.ba",
    "visual_slam_tpu_torch.backend.optimizer",
    "visual_slam_tpu_torch.camera",
    "visual_slam_tpu_torch.config",
    "visual_slam_tpu_torch.frontend",
    "visual_slam_tpu_torch.frontend.feature_manager",
    "visual_slam_tpu_torch.frontend.features",
    "visual_slam_tpu_torch.frontend.matcher",
    "visual_slam_tpu_torch.frontend.tracker",
    "visual_slam_tpu_torch.initializer",
    "visual_slam_tpu_torch.interop",
    "visual_slam_tpu_torch.io.native",
    "visual_slam_tpu_torch.loop_closing",
    "visual_slam_tpu_torch.loop_closing.loop_closing",
    "visual_slam_tpu_torch.loop_closing.pose_graph",
    "visual_slam_tpu_torch.loop_closing.signature",
    "visual_slam_tpu_torch.map",
    "visual_slam_tpu_torch.map.frame",
    "visual_slam_tpu_torch.map.keyframe",
    "visual_slam_tpu_torch.map.map",
    "visual_slam_tpu_torch.map.map_point",
    "visual_slam_tpu_torch.map.observation",
    "visual_slam_tpu_torch.map.pose",
    "visual_slam_tpu_torch.models",
    "visual_slam_tpu_torch.models.compiled_slam",
    "visual_slam_tpu_torch.pipeline",
    "visual_slam_tpu_torch.sensor_type",
    "visual_slam_tpu_torch.state",
    "visual_slam_tpu_torch.tracking",
    "visual_slam_tpu_torch.utils.logging",
    "visual_slam_tpu_torch.utils.metrics",
    "visual_slam_tpu_torch.utils.profiling",
    "visual_slam_tpu_torch.utils.tree",
    "visual_slam_tpu_torch.viz",
    "visual_slam_tpu_torch.viz.feature_viz",
    "visual_slam_tpu_torch.viz.map_viz",
    "visual_slam_tpu_torch.ops.detector",
    "visual_slam_tpu_torch.ops.epipolar",
    "visual_slam_tpu_torch.ops.fast",
    "visual_slam_tpu_torch.ops.guided_matching",
    "visual_slam_tpu_torch.ops.lie",
    "visual_slam_tpu_torch.ops.linalg",
    "visual_slam_tpu_torch.ops.match_kernels",
    "visual_slam_tpu_torch.ops.matching",
    "visual_slam_tpu_torch.ops.orb",
    "visual_slam_tpu_torch.ops.patch_kernels",
    "visual_slam_tpu_torch.ops.pnp",
    "visual_slam_tpu_torch.ops.projection",
    "visual_slam_tpu_torch.ops.triangulation",
    "visual_slam_tpu_torch.ops.pyramid",
]


def test_port_imports_without_jax():
    code = (
        "import importlib, sys, torch\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if k.startswith('jax'))\n"
        "assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
