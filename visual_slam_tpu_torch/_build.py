"""Build the port's CUDA kernels and bind them with ctypes.

At first use, one ``nvcc`` per ``csrc/*.cu`` (all started together)
compiles each source to an object, and one more links them into a shared
library with a plain C interface, ``build/libvslam_kernels.so``. The library
is rebuilt when the hash of the sources and flags changes. Nothing here runs
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argtypes; every pointer (and the stream) is a c_void_p.
SIGNATURES = {
    "vslam_patches_moments": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "vslam_hamming_top2": [_P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "vslam_guided_top2": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _F, _F, _P, _P, _P, _P],
    "vslam_extract_patches32": [_P, _I, _I, _P, _I, _P, _P],
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
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    tmp = LIB.with_name(f"{LIB.name}.{tag}")
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD / f"{src.stem}.{tag}.o" for src in srcs]
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for src, o in zip(srcs, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, LIB)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    STAMP.write_text(digest)
    return LIB


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once, wait for every one, raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")


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
