"""The port's ``Processing`` harness and ``io`` package on the CPU (the JAX
package's tests/test_processing.py and tests/test_processing_datasets.py
against the port), plus an in-memory source, the calibration loaders and
the dataset layouts. Gates as the JAX tests': every frame processed, state
OK, at least 2 keyframes and more than 50 landmarks; calibration values
exact."""
import json

import numpy as np
import pytest
import torch

from render import render_sequence
from visual_slam_tpu_torch.config import Config
from visual_slam_tpu_torch.io import DataSourceBase, DatasetSource, UniversalCalibration
from visual_slam_tpu_torch.io.datasets import EurocSource, KittiOdometrySource, TumRgbdSource, open_dataset
from visual_slam_tpu_torch.processing import Processing


def _cfg():
    cfg = Config()
    cfg.feature.num_features = 384
    cfg.feature.num_pyramid_levels = 2
    cfg.feature.fast_threshold = 12.0
    cfg.feature.grid_cells = 4
    cfg.initialization.min_inliers = 40
    cfg.tracking.keyframe_interval = 2
    cfg.optimization.window_size = 8
    return cfg


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    import cv2

    torch.set_num_threads(2)
    d = tmp_path_factory.mktemp("seq")
    frames, Ts_gt, K, _ = render_sequence(np.random.default_rng(4), n_frames=8, step=0.35)
    for i, f in enumerate(frames):
        cv2.imwrite(str(d / f"{i:06d}.png"), f.astype(np.uint8))
    (d / "calib.txt").write_text(f"P0: {K[0,0]} 0 {K[0,2]} 0 0 {K[1,1]} {K[1,2]} 0 0 0 1 0\n")
    return d


def test_processing_runs_with_calibration(dataset_dir):
    proc = Processing(dataset_dir, dataset_dir / "calib.txt", _cfg(), device="cpu")
    result = proc.run()
    assert result["frames"] == 8
    assert result["state"] == "OK"
    assert result["keyframes"] >= 2
    assert result["map_points"] > 50


def test_processing_kitti_layout(tmp_path):
    import cv2

    frames, Ts_gt, K, _ = render_sequence(np.random.default_rng(4), n_frames=6, step=0.35)
    (tmp_path / "image_0").mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(tmp_path / "image_0" / f"{i:06d}.png"), f.astype(np.uint8))
    (tmp_path / "times.txt").write_text("".join(f"{0.1*i:.6f}\n" for i in range(6)))
    (tmp_path / "calib.txt").write_text(f"P0: {K[0,0]} 0 {K[0,2]} 0 0 {K[1,1]} {K[1,2]} 0 0 0 1 0\n")
    cfg = Config()
    cfg.feature.num_features = 384
    cfg.feature.num_pyramid_levels = 2
    cfg.feature.fast_threshold = 12.0
    cfg.feature.grid_cells = 4
    cfg.initialization.min_inliers = 40
    proc = Processing(tmp_path, None, cfg, device="cpu")  # calibration from the layout
    assert proc.camera.fx == K[0, 0]
    assert isinstance(proc.source, KittiOdometrySource)
    result = proc.run()
    assert result["frames"] == 6
    assert result["keyframes"] >= 2


class MemorySource(DataSourceBase):
    def __init__(self, frames, dt=0.1):
        self.frames, self.dt, self.i = frames, dt, 0

    def get_frame(self):
        if self.i >= len(self.frames):
            return None, 0.0
        self.i += 1
        return self.frames[self.i - 1], (self.i - 1) * self.dt

    def is_ok(self):
        return self.i < len(self.frames)

    def num_frames(self):
        return len(self.frames)

    def get_frame_shape(self):
        return self.frames[0].shape[:2]


def test_processing_in_memory_source(tmp_path):
    frames, Ts_gt, K, _ = render_sequence(np.random.default_rng(4), n_frames=8, step=0.35)
    calib = tmp_path / "calib.json"
    calib.write_text(json.dumps({"K": K.tolist(), "width": 320, "height": 240}))
    proc = Processing(MemorySource(frames), calib, _cfg(), device="cpu")
    result = proc.run(max_cycles=7)
    assert result["frames"] == 7 and result["state"] == "OK"
    assert proc.source.i == 7


def test_heuristic_calibration(tmp_path):
    frames, _, _, _ = render_sequence(np.random.default_rng(4), n_frames=2, step=0.35)
    proc = Processing(MemorySource(frames), None, _cfg(), device="cpu")
    assert proc.camera.fx == pytest.approx(0.9 * 320)
    assert (proc.camera.width, proc.camera.height) == (320, 240)


def test_calibration_loaders(tmp_path):
    kitti = tmp_path / "calib.txt"
    kitti.write_text("P0: 700 0 600 0 0 700 180 0 0 0 1 0\nP1: 700 0 600 -378 0 700 180 0 0 0 1 0\n")
    c = UniversalCalibration().load_from(kitti)
    assert c.mono.fx == 700 and c.stereo.baseline == pytest.approx(0.54) and c.stereo.is_rectified
    from visual_slam_tpu.io.calibration import UniversalCalibration as JUniversalCalibration

    jrect, rect = JUniversalCalibration().load_from(kitti).stereo.rectification(), c.stereo.rectification()
    assert rect.keys() == jrect.keys() and rect["baseline"] == pytest.approx(jrect["baseline"], abs=1e-15)
    for k in ("R1", "R2", "P1", "P2", "Q", "K_new"):
        np.testing.assert_allclose(rect[k], jrect[k], rtol=0, atol=1e-12)
    ros = tmp_path / "cam.yaml"
    ros.write_text("image_width: 640\nimage_height: 480\ncamera_matrix: {rows: 3, cols: 3, data: "
                   "[500, 0, 320, 0, 500, 240, 0, 0, 1]}\ndistortion_coefficients: {rows: 1, cols: 5, data: "
                   "[0.1, -0.05, 0, 0, 0]}\n")
    c = UniversalCalibration().load_from(ros)
    assert c.mono.K[0, 2] == 320 and c.mono.width == 640 and c.mono.D[0] == pytest.approx(0.1)
    kalibr = tmp_path / "camchain.yaml"
    kalibr.write_text("cam0: {intrinsics: [450, 451, 300, 200], distortion_coeffs: [0.01, 0.02, 0, 0], "
                      "resolution: [600, 400]}\ncam1: {intrinsics: [450, 451, 300, 200], resolution: [600, 400], "
                      "T_cn_cnm1: [[1, 0, 0, -0.11], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]}\n")
    c = UniversalCalibration().load_from(kalibr)
    assert c.mono.K[1, 1] == 451 and c.stereo.baseline == pytest.approx(0.11)
    with pytest.raises(ValueError):
        UniversalCalibration().load_from(tmp_path / "calib.ini")


def test_dataset_layouts(tmp_path):
    import cv2

    img = (np.arange(40 * 60) % 255).reshape(40, 60).astype(np.uint8)
    # TUM: listings + depth association.
    tum = tmp_path / "tum"
    (tum / "rgb").mkdir(parents=True)
    (tum / "depth").mkdir()
    cv2.imwrite(str(tum / "rgb" / "0.png"), img)
    cv2.imwrite(str(tum / "depth" / "0.png"), np.full((40, 60), 5000, np.uint16))
    (tum / "rgb.txt").write_text("# rgb\n1.00 rgb/0.png\n")
    (tum / "depth.txt").write_text("1.01 depth/0.png\n")
    src = open_dataset(tum)
    assert isinstance(src, TumRgbdSource) and src.get_frame_shape() == (40, 60)
    frame, ts = src.get_frame()
    assert ts == 1.0 and np.array_equal(frame, img)
    assert src.get_depth(ts)[0, 0] == pytest.approx(1.0) and src.get_depth(2.0) is None
    # EuRoC: csv + sensor.yaml.
    eu = tmp_path / "euroc" / "mav0" / "cam0"
    (eu / "data").mkdir(parents=True)
    cv2.imwrite(str(eu / "data" / "5.png"), img)
    (eu / "data.csv").write_text("#timestamp,filename\n5000000000,5.png\n")
    (eu / "sensor.yaml").write_text("intrinsics: [400, 401, 30, 20]\ndistortion_coefficients: [0.1, 0, 0, 0]\n"
                                    "resolution: [60, 40]\n")
    src = open_dataset(tmp_path / "euroc")
    assert isinstance(src, EurocSource) and src.calibration.K[1, 1] == 401
    assert src.get_frame()[1] == pytest.approx(5.0) and not src.is_ok()
    # A bare image directory.
    bare = tmp_path / "bare"
    bare.mkdir()
    for i in range(3):
        cv2.imwrite(str(bare / f"{i}.png"), img)
    src = open_dataset(bare)
    assert isinstance(src, DatasetSource) and src.num_frames() == 3
    src.seek(2)
    assert src.get_frame()[1] == pytest.approx(0.2) and not src.is_ok()
