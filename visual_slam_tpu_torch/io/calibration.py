"""Calibration file loaders: KITTI, ROS/OpenCV YAML, Kalibr camchain, JSON
(port of ``visual_slam_tpu.io.calibration``, host-side numpy).

``MonoCalibration`` (K, D, model), ``StereoCalibration`` (left/right, R, T,
baseline, ``is_rectified``), ``UniversalCalibration`` dispatching on the
file suffix and content. ``StereoCalibration.rectification`` and
``rectify_images`` rectify a raw stereo rig through ``ops.rectify``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch


@dataclass
class MonoCalibration:
    K: np.ndarray = field(default_factory=lambda: np.eye(3))
    D: np.ndarray = field(default_factory=lambda: np.zeros(5))
    model: str = "pinhole"
    width: int = 0
    height: int = 0

    @property
    def fx(self) -> float:
        return float(self.K[0, 0])


@dataclass
class StereoCalibration:
    left: MonoCalibration = field(default_factory=MonoCalibration)
    right: MonoCalibration = field(default_factory=MonoCalibration)
    R: np.ndarray = field(default_factory=lambda: np.eye(3))
    T: np.ndarray = field(default_factory=lambda: np.zeros(3))

    @property
    def baseline(self) -> float:
        return float(np.linalg.norm(self.T))

    @property
    def is_rectified(self) -> bool:
        """True when the rig is already row-aligned (pure-x baseline,
        identity rotation, no distortion)."""
        t = np.ravel(self.T)
        return (
            bool(np.allclose(self.R, np.eye(3), atol=1e-6))
            and bool(np.allclose(t[1:], 0.0, atol=1e-9 + 1e-6 * abs(t[0])))
            and bool(np.allclose(self.left.D, 0.0))
            and bool(np.allclose(self.right.D, 0.0))
        )

    def rectification(self) -> dict:
        """R1/R2/P1/P2/Q, K_new and the baseline of the raw rig
        (``ops.rectify.stereo_rectify``, host math)."""
        from ..ops.rectify import stereo_rectify

        return stereo_rectify(self.left.K, self.left.D, self.right.K, self.right.D, self.R, self.T)

    def rectify_images(self, img_left, img_right, rect: dict | None = None, device=None):
        """Dense path: both raw images resampled into the rectified rig on
        ``device`` (the card unless the caller asks for the CPU). Returns
        (left', right', K_new, baseline), the images as float32 tensors:
        the input of the rectified stereo pipeline."""
        from ..ops.rectify import remap_bilinear, undistort_rectify_map
        from ..utils.device import default_device

        dev = default_device(device)
        rect = rect or self.rectification()

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

        H, W = np.asarray(img_left).shape[:2]
        m1 = undistort_rectify_map(t(self.left.K), t(self.left.D), t(rect["R1"]), t(rect["K_new"]), H, W)
        m2 = undistort_rectify_map(t(self.right.K), t(self.right.D), t(rect["R2"]), t(rect["K_new"]), H, W)
        return remap_bilinear(t(img_left), m1), remap_bilinear(t(img_right), m2), rect["K_new"], rect["baseline"]


class UniversalCalibration:
    """Suffix-dispatching loader: ``.txt`` -> KITTI P-matrices,
    ``.yaml/.yml`` -> ROS/OpenCV or Kalibr, ``.json`` -> K/D/size."""

    def __init__(self):
        self.mono: MonoCalibration | None = None
        self.stereo: StereoCalibration | None = None

    def load_from(self, path: str | Path) -> "UniversalCalibration":
        path = Path(path)
        suffix = path.suffix.lower()
        if suffix == ".txt":
            self._load_kitti(path)
        elif suffix in (".yaml", ".yml"):
            text = path.read_text()
            if "camchain" in path.name or "cam0" in text:
                self._load_kalibr(path)
            else:
                self._load_ros(path)
        elif suffix == ".json":
            self._load_json(path)
        else:
            raise ValueError(f"Unsupported calibration format: {path}")
        return self

    def _load_kitti(self, path: Path) -> None:
        """KITTI odometry calib.txt: ``P0: <12 floats>`` rows are 3x4
        projection matrices of rectified cameras; the baseline comes from
        P1[0, 3] = -fx * b."""
        Ps = {}
        for line in path.read_text().splitlines():
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            try:
                arr = np.array([float(v) for v in vals.split()])
            except ValueError:
                continue
            if arr.size == 12:
                Ps[key.strip()] = arr.reshape(3, 4)
        if not Ps:
            raise ValueError(f"No projection matrices in {path}")
        P0 = Ps.get("P0", next(iter(Ps.values())))
        K = P0[:, :3].copy()
        self.mono = MonoCalibration(K=K, D=np.zeros(5), model="pinhole")
        if "P1" in Ps:
            K1 = Ps["P1"][:, :3]
            baseline = -Ps["P1"][0, 3] / K1[0, 0]
            self.stereo = StereoCalibration(
                left=MonoCalibration(K=K.copy()), right=MonoCalibration(K=K1.copy()),
                R=np.eye(3), T=np.array([baseline, 0.0, 0.0]),
            )

    def _load_ros(self, path: Path) -> None:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f.read().replace("!!opencv-matrix", ""))

        def mat(node):
            if isinstance(node, dict) and "data" in node:
                return np.asarray(node["data"], np.float64).reshape(node.get("rows", 3), node.get("cols", -1))
            return np.asarray(node, np.float64)

        def grab(*names, default=None):
            for n in names:
                if n in data:
                    return mat(data[n])
            return default

        K = grab("camera_matrix", "K", "M1")
        D = grab("distortion_coefficients", "D", "D1", default=np.zeros(5))
        if K is None:
            raise ValueError(f"No camera_matrix in {path}")
        w = int(data.get("image_width", 0))
        h = int(data.get("image_height", 0))
        self.mono = MonoCalibration(K=K.reshape(3, 3), D=np.ravel(D)[:5], width=w, height=h)
        K2 = grab("camera_matrix_right", "K2", "M2")
        if K2 is not None:
            D2 = grab("distortion_coefficients_right", "D2", default=np.zeros(5))
            R = grab("R", default=np.eye(3))
            T = grab("T", default=np.zeros(3))
            self.stereo = StereoCalibration(
                left=self.mono, right=MonoCalibration(K=K2.reshape(3, 3), D=np.ravel(D2)[:5]),
                R=R.reshape(3, 3), T=np.ravel(T)[:3],
            )

    def _load_kalibr(self, path: Path) -> None:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f)

        def cam_to_mono(cam: dict) -> MonoCalibration:
            fu, fv, cu, cv_ = cam["intrinsics"]
            D = np.ravel(cam.get("distortion_coeffs", np.zeros(4)))
            res = cam.get("resolution", [0, 0])
            return MonoCalibration(
                K=np.array([[fu, 0, cu], [0, fv, cv_], [0, 0, 1.0]]), D=np.pad(D, (0, max(0, 5 - D.size)))[:5],
                model=cam.get("camera_model", "pinhole"), width=int(res[0]), height=int(res[1]),
            )

        self.mono = cam_to_mono(data["cam0"])
        if "cam1" in data:
            T_cn = np.asarray(data["cam1"].get("T_cn_cnm1", np.eye(4)))
            self.stereo = StereoCalibration(left=self.mono, right=cam_to_mono(data["cam1"]), R=T_cn[:3, :3],
                                            T=T_cn[:3, 3])

    def _load_json(self, path: Path) -> None:
        import json

        data = json.loads(path.read_text())
        self.mono = MonoCalibration(
            K=np.asarray(data["K"], np.float64).reshape(3, 3),
            D=np.asarray(data.get("D", np.zeros(5)), np.float64).ravel()[:5],
            width=int(data.get("width", 0)), height=int(data.get("height", 0)),
        )
