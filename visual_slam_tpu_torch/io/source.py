"""Frame sources: image-directory datasets, video files, live cameras
(port of ``visual_slam_tpu.io.source``, host-side numpy).

``DataSourceBase.get_frame()/is_ok()/num_frames()/get_frame_shape()``,
``DatasetSource`` (sorted image directory, timestamp = index / fps, or a
timestamps file), ``VideoSource`` (target-fps frame skipping, seek, msec
timestamps), ``CameraSource`` (live capture). Images are decoded on the
host with OpenCV when it imports, else PIL; neither is imported before
the first read, so a machine without an image decoder can still run the
facade from in-memory sources.
"""
from __future__ import annotations

import abc
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def _cv2():
    """OpenCV, or None without it."""
    try:
        import cv2  # type: ignore
    except ImportError:  # pragma: no cover
        return None
    return cv2


def imread_gray(path: str | Path) -> np.ndarray:
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError(f"Failed to read {path}")
        return img
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"))


def imread_color(path: str | Path) -> np.ndarray:
    """Returns RGB uint8."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"Failed to read {path}")
        return img[:, :, ::-1]
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def to_gray(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return img
    return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]).astype(img.dtype)


class DataSourceBase(abc.ABC):
    @abc.abstractmethod
    def get_frame(self) -> Tuple[Optional[np.ndarray], float]:
        """Returns (image or None, timestamp seconds)."""

    @abc.abstractmethod
    def is_ok(self) -> bool: ...

    def num_frames(self) -> int:
        return -1

    def get_frame_shape(self) -> Tuple[int, int]:
        return (0, 0)

    def release(self) -> None:
        pass


IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".pgm", ".ppm", ".tif", ".tiff")


class DatasetSource(DataSourceBase):
    """Sorted image-directory reader."""

    def __init__(self, image_dir: str | Path, fps: float = 10.0, grayscale: bool = True,
                 timestamps_file: str | Path | None = None):
        self.image_dir = Path(image_dir)
        self.paths = sorted(p for p in self.image_dir.iterdir() if p.suffix.lower() in IMAGE_EXTS)
        if not self.paths:
            raise FileNotFoundError(f"No images in {image_dir}")
        self.fps = fps
        self.grayscale = grayscale
        self.idx = 0
        self.timestamps = None
        if timestamps_file is not None:
            self.timestamps = np.loadtxt(str(timestamps_file), usecols=0)

    def get_frame(self):
        if self.idx >= len(self.paths):
            return None, 0.0
        p = self.paths[self.idx]
        img = imread_gray(p) if self.grayscale else imread_color(p)
        if self.timestamps is not None and self.idx < len(self.timestamps):
            ts = float(self.timestamps[self.idx])
        else:
            ts = self.idx / self.fps
        self.idx += 1
        return img, ts

    def is_ok(self) -> bool:
        return self.idx < len(self.paths)

    def num_frames(self) -> int:
        return len(self.paths)

    def get_frame_shape(self):
        img = imread_gray(self.paths[0]) if self.grayscale else imread_color(self.paths[0])
        return img.shape[:2]

    def seek(self, idx: int) -> None:
        self.idx = int(np.clip(idx, 0, len(self.paths)))


class VideoSource(DataSourceBase):
    """Video-file reader with target-fps frame skipping (needs OpenCV)."""

    def __init__(self, video_path: str | Path, target_fps: float | None = None, grayscale: bool = True):
        cv2 = self._cv2 = _cv2()
        if cv2 is None:
            raise RuntimeError("VideoSource requires OpenCV")
        self.cap = cv2.VideoCapture(str(video_path))
        if not self.cap.isOpened():
            raise IOError(f"Failed to open video {video_path}")
        self.src_fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.target_fps = target_fps or self.src_fps
        self.skip = max(int(round(self.src_fps / self.target_fps)), 1)
        self.grayscale = grayscale
        self._ok = True

    def get_frame(self):
        cv2 = self._cv2
        for _ in range(self.skip - 1):
            self.cap.grab()
        ok, frame = self.cap.read()
        if not ok:
            self._ok = False
            return None, 0.0
        ts = self.cap.get(cv2.CAP_PROP_POS_MSEC) / 1000.0
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY) if self.grayscale else frame[:, :, ::-1]
        return frame, ts

    def is_ok(self) -> bool:
        return self._ok and self.cap.isOpened()

    def num_frames(self) -> int:
        n = int(self.cap.get(self._cv2.CAP_PROP_FRAME_COUNT))
        return max(n // self.skip, 0)

    def get_frame_shape(self):
        h = int(self.cap.get(self._cv2.CAP_PROP_FRAME_HEIGHT))
        w = int(self.cap.get(self._cv2.CAP_PROP_FRAME_WIDTH))
        return (h, w)

    def seek(self, frame_idx: int) -> None:
        self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, frame_idx * self.skip)

    def release(self) -> None:
        self.cap.release()


class CameraSource(DataSourceBase):
    """Live capture device (needs OpenCV)."""

    def __init__(self, device: int = 0, grayscale: bool = True):
        cv2 = self._cv2 = _cv2()
        if cv2 is None:
            raise RuntimeError("CameraSource requires OpenCV")
        self.cap = cv2.VideoCapture(device)
        if not self.cap.isOpened():
            raise IOError(f"Failed to open camera {device}")
        self.grayscale = grayscale
        self._ok = True
        self._t0: float | None = None

    def get_frame(self):
        import time

        ok, frame = self.cap.read()
        if not ok:
            self._ok = False
            return None, 0.0
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
        frame = self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2GRAY) if self.grayscale else frame[:, :, ::-1]
        return frame, now - self._t0

    def is_ok(self) -> bool:
        return self._ok and self.cap.isOpened()

    def get_frame_shape(self):
        h = int(self.cap.get(self._cv2.CAP_PROP_FRAME_HEIGHT))
        w = int(self.cap.get(self._cv2.CAP_PROP_FRAME_WIDTH))
        return (h, w)

    def release(self) -> None:
        self.cap.release()
