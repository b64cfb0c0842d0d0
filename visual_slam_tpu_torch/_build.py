"""Build the port's CUDA kernels and bind them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, ``build/libvslam_kernels.so``, at first use. The library is
rebuilt when the hash of the sources and flags changes. Nothing here runs
at import: the CPU tests import every module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
LIB = BUILD / "libvslam_kernels.so"
STAMP = BUILD / "libvslam_kernels.sha256"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argtypes; every pointer (and the stream) is a c_void_p.
SIGNATURES = {
    "vslam_patches_moments": [_P, _P, _I, _I, _P, _I, _P, _P, _P],
    "vslam_hamming_top2": [_P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P],
    "vslam_guided_top2": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _F, _F, _P, _P, _P, _P],
}

_lib = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(force: bool = False) -> Path:
    """Compile the kernels unless an up-to-date library exists."""
    digest = source_hash()
    if not force and LIB.exists() and STAMP.exists() and STAMP.read_text() == digest:
        return LIB
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_name(f"{LIB.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, LIB)
    STAMP.write_text(digest)
    return LIB


def lib() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check_args(fn: str, device: torch.device, specs) -> None:
    """Raise unless every (name, tensor, dtype, shape) in ``specs`` is a
    contiguous tensor of that dtype and shape on ``device``: the kernels
    take raw pointers and trust them."""
    for name, t, dtype, shape in specs:
        if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be a contiguous {dtype} tensor of shape {tuple(shape)} on "
                f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
