"""App harness: dataset or video -> SLAM frame loop (port of
``visual_slam_tpu.processing``).

``Processing(source, calibration_file, config, device=...)`` builds the
source (a ``DataSourceBase``, a dataset directory whose layout
``io.datasets.open_dataset`` recognizes, or a video file), the calibration
(an explicit file, else the dataset's own, else a heuristic focal length),
the camera and the ``SLAM`` facade on ``device`` (the card unless the
caller asks for the CPU); ``run()`` feeds every frame and shuts down. A
stereo configuration takes the source's [left, right] frames and the
calibration's baseline; an RGB-D one also feeds the source's depth map of
each frame (``get_depth``).
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import numpy as np

from .camera import PinholeCamera
from .config import Config
from .io.calibration import UniversalCalibration
from .io.source import DataSourceBase, DatasetSource, VideoSource
from .sensor_type import SensorType
from .slam import SLAM
from .utils.device import default_device
from .utils.logging import get_logger


class Processing:
    def __init__(
        self,
        source: str | Path | DataSourceBase,
        calibration_file: str | Path | None = None,
        config: Config | None = None,
        sleep_time: float = 0.0,
        log_dir: str | None = None,
        device=None,
    ):
        self.config = config or Config()
        self.device = default_device(device)
        self.sleep_time = sleep_time
        self.logger = get_logger("processing", log_dir)

        if isinstance(source, DataSourceBase):
            self.source = source
        else:
            p = Path(source)
            if p.is_dir():
                from .io.datasets import open_dataset

                # KITTI, TUM and EuRoC layouts; a bare directory falls
                # through to DatasetSource.
                self.source = open_dataset(p)
                if isinstance(self.source, DatasetSource):
                    self.source = DatasetSource(p, fps=self.config.camera.fps)
            else:
                self.source = VideoSource(p, target_fps=self.config.camera.fps)

        h, w = self.source.get_frame_shape()
        # Calibration: explicit file > dataset-provided > heuristic.
        ds_calib = getattr(self.source, "calibration", None)
        if calibration_file is not None:
            calib = UniversalCalibration().load_from(calibration_file)
            K, D = calib.mono.K, calib.mono.D
            baseline = calib.stereo.baseline if calib.stereo else 0.0
        elif ds_calib is not None:
            mono = ds_calib.mono if hasattr(ds_calib, "mono") else ds_calib
            K, D = mono.K, mono.D
            stereo = getattr(ds_calib, "stereo", None)
            baseline = stereo.baseline if stereo is not None else 0.0
        else:
            f = 0.9 * max(w, h)
            K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
            D = None
            baseline = 0.0
            self.logger.warning("no calibration file; using heuristic K (f=%.1f)", f)

        self.camera = PinholeCamera(width=w, height=h, K=K, D=D, fps=self.config.camera.fps,
                                    sensor_type=SensorType[self.config.camera.sensor_type.upper()], baseline=baseline)
        self.config.camera.width = w
        self.config.camera.height = h
        self.slam = SLAM(self.camera, self.config, log_dir=log_dir, device=self.device)

    def run(self, max_cycles: Optional[int] = None) -> dict:
        n = 0
        t0 = time.perf_counter()
        get_depth = getattr(self.source, "get_depth", None)
        while self.source.is_ok():
            if max_cycles is not None and n >= max_cycles:
                break
            img, ts = self.source.get_frame()
            if img is None:
                break
            images = img if isinstance(img, list) else [img]
            depth = get_depth(ts) if get_depth is not None and self.config.camera.sensor_type == "rgbd" else None
            self.slam.track(images, ts, depth=depth)
            n += 1
            if self.sleep_time > 0:
                time.sleep(self.sleep_time)
        dt = time.perf_counter() - t0
        self.slam.shutdown()
        fps = n / dt if dt > 0 else 0.0
        self.logger.info("processed %d frames in %.2fs (%.1f FPS)", n, dt, fps)
        return {
            "frames": n,
            "seconds": dt,
            "fps": fps,
            "state": self.slam.state.name,
            "keyframes": self.slam.map.num_keyframes(),
            "map_points": self.slam.map.num_map_points(),
        }
