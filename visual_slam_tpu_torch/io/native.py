"""ctypes bindings for the native C++ frame-ingest runtime
(``native/loader.cpp`` at the repository root; port of
``visual_slam_tpu.io.native``).

The loader is compiled with ``g++`` on first use into the port's own
``visual_slam_tpu_torch/build/libvslam_loader.so``, and rebuilt when the
hash of the source and the compiler flags changes. The library is written
under a name unique to the process and moved into place, so processes that
build at once do not race. A build or decode failure raises: no Python
decoder stands in for the loader. Provides:

* ``decode_image(path)``: PNG/PGM/PPM/BMP decode without OpenCV or PIL;
* ``NativeDatasetSource``: a ``DataSourceBase`` whose decode and grayscale
  conversion run in background C++ worker threads with a bounded in-order
  prefetch ring, so ``get_frame()`` returns at once while the card works
  on the previous frame.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .source import IMAGE_EXTS, DataSourceBase

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "loader.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
_LIB = _BUILD_DIR / "libvslam_loader.so"
_STAMP = _BUILD_DIR / "libvslam_loader.sha256"
_CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_LD_FLAGS = ["-lz", "-lpthread"]

_lib = None
_lib_lock = threading.Lock()


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(_CXX_FLAGS + _LD_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return h.hexdigest()


def _compile(force: bool = False) -> Path:
    """The loader library, compiled unless an up-to-date one exists."""
    digest = _source_hash()
    if not force and _LIB.exists() and _STAMP.exists() and _STAMP.read_text() == digest:
        return _LIB
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *_CXX_FLAGS, str(_SRC), "-o", str(tmp), *_LD_FLAGS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, _LIB)
    finally:
        tmp.unlink(missing_ok=True)
    stamp_tmp = _STAMP.with_name(f"{_STAMP.name}.{os.getpid()}.tmp")
    stamp_tmp.write_text(digest)
    os.replace(stamp_tmp, _STAMP)
    return _LIB


def get_lib():
    """The bound loader library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_compile()))
            lib.vslam_decode.restype = ctypes.c_int
            lib.vslam_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.vslam_dataset_open.restype = ctypes.c_void_p
            lib.vslam_dataset_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            for fn in ("vslam_dataset_width", "vslam_dataset_height", "vslam_dataset_size", "vslam_dataset_errors"):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = [ctypes.c_void_p]
            lib.vslam_dataset_next.restype = ctypes.c_int
            lib.vslam_dataset_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.vslam_dataset_close.restype = None
            lib.vslam_dataset_close.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def decode_image(path: str | Path) -> np.ndarray:
    """Decode PNG/PGM/PPM/BMP natively: (H, W) or (H, W, 3) uint8."""
    lib = get_lib()
    w = ctypes.c_int()
    h = ctypes.c_int()
    ch = ctypes.c_int()
    rc = lib.vslam_decode(str(path).encode(), None, 0, ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}) for {path}")
    buf = np.empty(h.value * w.value * ch.value, np.uint8)
    rc = lib.vslam_decode(
        str(path).encode(), buf.ctypes.data_as(ctypes.c_void_p), buf.size,
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch),
    )
    if rc != 0:
        raise IOError(f"native decode failed ({rc}) for {path}")
    if ch.value == 1:
        return buf.reshape(h.value, w.value)
    return buf.reshape(h.value, w.value, ch.value)


class NativeDatasetSource(DataSourceBase):
    """Prefetching image-directory source backed by the C++ runtime:
    ``get_frame()`` gives float32 grayscale (or RGB uint8 with
    ``grayscale=False``) and the timestamp ``idx / fps``, or the timestamps
    file's value."""

    def __init__(
        self,
        image_dir: str | Path,
        fps: float = 10.0,
        grayscale: bool = True,
        n_workers: int = 2,
        prefetch: int = 8,
        timestamps_file: str | Path | None = None,
    ):
        self.paths = sorted(p for p in Path(image_dir).iterdir() if p.suffix.lower() in IMAGE_EXTS)
        if not self.paths:
            raise FileNotFoundError(f"No images in {image_dir}")
        self.fps = fps
        self.grayscale = grayscale
        lib = get_lib()
        joined = "\n".join(str(p) for p in self.paths).encode()
        self._h = lib.vslam_dataset_open(joined, int(grayscale), n_workers, prefetch)
        if not self._h:
            raise IOError(f"native dataset open failed for {image_dir}")
        self._lib = lib
        self.width = lib.vslam_dataset_width(self._h)
        self.height = lib.vslam_dataset_height(self._h)
        self._n = lib.vslam_dataset_size(self._h)
        self._done = False
        self.timestamps = np.loadtxt(str(timestamps_file), usecols=0) if timestamps_file else None

    def get_frame(self):
        if self._done:
            return None, 0.0
        if self.grayscale:
            out = np.empty((self.height, self.width), np.float32)
        else:
            out = np.empty((self.height, self.width, 3), np.uint8)
        idx = self._lib.vslam_dataset_next(self._h, out.ctypes.data_as(ctypes.c_void_p))
        if idx < 0:
            self._done = True
            return None, 0.0
        if idx >= self._n - 1:
            self._done = True
        ts = (
            float(self.timestamps[idx])
            if self.timestamps is not None and idx < len(self.timestamps)
            else idx / self.fps
        )
        return out, ts

    def is_ok(self) -> bool:
        return not self._done

    def num_frames(self) -> int:
        return self._n

    def get_frame_shape(self):
        return (self.height, self.width)

    def decode_errors(self) -> int:
        return self._lib.vslam_dataset_errors(self._h)

    def release(self) -> None:
        if getattr(self, "_h", None):
            self._lib.vslam_dataset_close(self._h)
            self._h = None
