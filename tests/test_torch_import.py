"""The torch port imports without JAX."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

MODULES = [
    "visual_slam_tpu_torch",
    "visual_slam_tpu_torch._build",
    "visual_slam_tpu_torch.interop",
    "visual_slam_tpu_torch.pipeline",
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
