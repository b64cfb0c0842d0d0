"""Standard dataset layouts: KITTI odometry, TUM RGB-D, EuRoC MAV
(port of ``visual_slam_tpu.io.datasets``, host-side numpy).

Each adapter reads its layout's timestamp file, stereo folder or depth
association, and yields frames plus calibration through
``DataSourceBase``: KITTI with ``stereo=True`` and EuRoC yield [left,
right] pairs for the stereo facade, TUM's ``get_depth`` the depth maps
(metres) of the RGB-D facade.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from .calibration import MonoCalibration, UniversalCalibration
from .source import DataSourceBase, DatasetSource, _cv2, imread_gray


def _imread_depth16(path) -> np.ndarray:
    """16-bit depth PNG reader (the 8-bit grayscale reader would clip)."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if img is None:
            raise IOError(f"failed to read {path}")
        return img
    from PIL import Image

    return np.asarray(Image.open(path))


class KittiOdometrySource(DataSourceBase):
    """KITTI odometry sequence: ``image_0/*.png`` (left gray), ``image_1/``
    (right, optional), ``times.txt`` (seconds), ``calib.txt`` (P0/P1).
    ``stereo=True`` yields [left, right] image lists."""

    def __init__(self, seq_dir: str | Path, stereo: bool = False):
        self.seq_dir = Path(seq_dir)
        self.left = sorted((self.seq_dir / "image_0").glob("*.png"))
        if not self.left:
            raise FileNotFoundError(f"no images under {self.seq_dir}/image_0")
        self.right = sorted((self.seq_dir / "image_1").glob("*.png")) if stereo else []
        self.stereo = stereo and len(self.right) == len(self.left)
        times_file = self.seq_dir / "times.txt"
        self.times = np.loadtxt(str(times_file)) if times_file.exists() else None
        calib_file = self.seq_dir / "calib.txt"
        self.calibration: Optional[UniversalCalibration] = (
            UniversalCalibration().load_from(calib_file) if calib_file.exists() else None
        )
        self.idx = 0

    def get_frame(self):
        if self.idx >= len(self.left):
            return None, 0.0
        img = imread_gray(self.left[self.idx])
        if self.stereo:
            img = [img, imread_gray(self.right[self.idx])]
        ts = float(self.times[self.idx]) if self.times is not None else self.idx / 10.0
        self.idx += 1
        return img, ts

    def is_ok(self) -> bool:
        return self.idx < len(self.left)

    def num_frames(self) -> int:
        return len(self.left)

    def get_frame_shape(self):
        return imread_gray(self.left[0]).shape[:2]


class TumRgbdSource(DataSourceBase):
    """TUM RGB-D sequence: ``rgb.txt`` / ``depth.txt`` listings of
    ``timestamp filename``, ``rgb/*.png`` and 16-bit ``depth/*.png`` (scale
    1/5000 m). Depth is associated to rgb by the nearest timestamp within
    ``max_dt``."""

    DEPTH_SCALE = 1.0 / 5000.0

    def __init__(self, seq_dir: str | Path, with_depth: bool = True, max_dt: float = 0.02):
        self.seq_dir = Path(seq_dir)
        self.rgb = self._read_listing(self.seq_dir / "rgb.txt")
        if not self.rgb:
            raise FileNotFoundError(f"no rgb.txt listing in {seq_dir}")
        self.depth = self._read_listing(self.seq_dir / "depth.txt") if with_depth else []
        self.max_dt = max_dt
        self.idx = 0

    @staticmethod
    def _read_listing(path: Path):
        if not path.exists():
            return []
        rows = []
        for line in path.read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rel = line.split()[:2]
            rows.append((float(ts), rel))
        return rows

    def get_frame(self):
        if self.idx >= len(self.rgb):
            return None, 0.0
        ts, rel = self.rgb[self.idx]
        img = imread_gray(self.seq_dir / rel)
        self.idx += 1
        return img, ts

    def get_depth(self, ts: float) -> Optional[np.ndarray]:
        """Nearest-timestamp depth map in metres, or None."""
        if not self.depth:
            return None
        dts = np.array([t for t, _ in self.depth])
        j = int(np.argmin(np.abs(dts - ts)))
        if abs(dts[j] - ts) > self.max_dt:
            return None
        return _imread_depth16(self.seq_dir / self.depth[j][1]).astype(np.float32) * self.DEPTH_SCALE

    def is_ok(self) -> bool:
        return self.idx < len(self.rgb)

    def num_frames(self) -> int:
        return len(self.rgb)

    def get_frame_shape(self):
        return imread_gray(self.seq_dir / self.rgb[0][1]).shape[:2]


class EurocSource(DataSourceBase):
    """EuRoC MAV sequence: ``mav0/cam0/data.csv`` (``timestamp_ns,
    filename``), ``mav0/cam0/data/*.png`` (+ cam1 for stereo) and
    ``mav0/cam0/sensor.yaml`` (Kalibr-style intrinsics)."""

    def __init__(self, seq_dir: str | Path, stereo: bool = False):
        self.seq_dir = Path(seq_dir)
        cam0 = self.seq_dir / "mav0" / "cam0"
        self.rows = self._read_csv(cam0 / "data.csv")
        if not self.rows:
            raise FileNotFoundError(f"no cam0 data.csv under {seq_dir}")
        self.cam0_dir = cam0 / "data"
        self.cam1_dir = self.seq_dir / "mav0" / "cam1" / "data"
        self.stereo = stereo and self.cam1_dir.exists()
        self.calibration = self._read_sensor_yaml(cam0 / "sensor.yaml")
        self.idx = 0

    @staticmethod
    def _read_csv(path: Path):
        if not path.exists():
            return []
        rows = []
        for line in path.read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            rows.append((int(parts[0]), parts[1].strip()))
        return rows

    @staticmethod
    def _read_sensor_yaml(path: Path) -> Optional[MonoCalibration]:
        if not path.exists():
            return None
        import yaml

        data = yaml.safe_load(path.read_text())
        intr = data.get("intrinsics")
        if not intr:
            return None
        fu, fv, cu, cv_ = intr
        D = np.ravel(data.get("distortion_coefficients", np.zeros(4)))
        res = data.get("resolution", [0, 0])
        return MonoCalibration(K=np.array([[fu, 0, cu], [0, fv, cv_], [0, 0, 1.0]]),
                               D=np.pad(D, (0, max(0, 5 - D.size)))[:5], width=int(res[0]), height=int(res[1]))

    def get_frame(self):
        if self.idx >= len(self.rows):
            return None, 0.0
        ts_ns, fname = self.rows[self.idx]
        img = imread_gray(self.cam0_dir / fname)
        if self.stereo:
            right = self.cam1_dir / fname
            if right.exists():
                img = [img, imread_gray(right)]
        self.idx += 1
        return img, ts_ns * 1e-9

    def is_ok(self) -> bool:
        return self.idx < len(self.rows)

    def num_frames(self) -> int:
        return len(self.rows)

    def get_frame_shape(self):
        return imread_gray(self.cam0_dir / self.rows[0][1]).shape[:2]


def open_dataset(path: str | Path, **kwargs) -> DataSourceBase:
    """Layout sniffing: KITTI (image_0/), EuRoC (mav0/), TUM (rgb.txt),
    else a bare image directory."""
    p = Path(path)
    if (p / "image_0").is_dir():
        return KittiOdometrySource(p, **kwargs)
    if (p / "mav0").is_dir():
        return EurocSource(p, **kwargs)
    if (p / "rgb.txt").exists():
        return TumRgbdSource(p, **kwargs)
    return DatasetSource(p)
