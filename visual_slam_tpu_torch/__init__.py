"""visual_slam_tpu_torch — the PyTorch + CUDA port of visual_slam_tpu.

Module names mirror the JAX package (``visual_slam_tpu``), which stays the
reference every piece here is tested against. Plain tensor code is
PyTorch; each Pallas kernel of the JAX package on the ported path is a
hand-written CUDA C++ kernel for Hopper (``csrc/``, built by ``_build.py``)
with a plain PyTorch version of the same function beside its wrapper.

Ported so far (README.md lists it): the fused mono tracking step, also
over B sequences at once (``parallel.make_batched_vo``), the mono
``CompiledSLAM`` main path with loop closing, the host SLAM facade (mono,
stereo, RGB-D), and checkpoint and resume in the JAX package's file format.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (SE(3) chains, DLT normal matrices, Gauss-Newton systems) needs
# true f32 products: the counterpart of the JAX package's
# ``jax_default_matmul_precision="highest"``.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
