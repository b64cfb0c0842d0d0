"""The port's entry points run on the card unless the caller asks for the
CPU: with no ``device`` and no CUDA device they raise, never falling back."""
import numpy as np
import pytest
import torch

from visual_slam_tpu_torch.backend.optimizer import LMOptimizer
from visual_slam_tpu_torch.camera import PinholeCamera
from visual_slam_tpu_torch.config import Config
from visual_slam_tpu_torch.frontend.features import FastOrbFeature2D
from visual_slam_tpu_torch.frontend.tracker import FeatureTracker
from visual_slam_tpu_torch.handlers import GlobalHandler, LocalHandler
from visual_slam_tpu_torch.io import DataSourceBase
from visual_slam_tpu_torch.local_mapping import LocalMapping
from visual_slam_tpu_torch.map import Map
from visual_slam_tpu_torch.models import BatchedVO, CompiledSLAM, CompiledVO, MonoVO
from visual_slam_tpu_torch.parallel import make_batched_vo
from visual_slam_tpu_torch.pipeline import make_frame_step, make_track_step
from visual_slam_tpu_torch.processing import Processing
from visual_slam_tpu_torch.slam import SLAM
from visual_slam_tpu_torch.tracking import Tracking
from visual_slam_tpu_torch.utils.device import default_device

K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])


def _cam():
    return PinholeCamera(width=320, height=240, K=K)


class _Blank(DataSourceBase):
    def get_frame(self):
        return np.zeros((240, 320), np.float32), 0.0

    def is_ok(self):
        return True

    def get_frame_shape(self):
        return (240, 320)

ENTRY_POINTS = {
    "CompiledSLAM": lambda **kw: CompiledSLAM(PinholeCamera(width=320, height=240, K=K), Config(), **kw),
    "make_track_step": lambda **kw: make_track_step(K, num_features=64, **kw),
    "FeatureTracker": lambda **kw: FeatureTracker(Config().feature, **kw),
    "FastOrbFeature2D": lambda **kw: FastOrbFeature2D(num_features=64, **kw),
    "LMOptimizer": lambda **kw: LMOptimizer(Config(), PinholeCamera(width=320, height=240, K=K), **kw),
    "SLAM": lambda **kw: SLAM(_cam(), Config(), **kw),
    "Tracking": lambda **kw: Tracking(_cam(), Config(), FeatureTracker(Config().feature, device="cpu"), Map(), None,
                                      **kw),
    "LocalMapping": lambda **kw: LocalMapping(_cam(), Config(), Map(), FeatureTracker(Config().feature, device="cpu"),
                                              **kw),
    "LocalHandler": lambda **kw: LocalHandler(Map(), None, _cam(), Config(), **kw),
    "GlobalHandler": lambda **kw: GlobalHandler(Map(), None, _cam(), Config(), **kw),
    "Processing": lambda **kw: Processing(_Blank(), None, Config(), **kw),
    "make_frame_step": lambda **kw: make_frame_step(K, 320.0, 240.0, num_features=64, **kw),
    "make_batched_vo": lambda **kw: make_batched_vo(K, num_features=64, **kw),
    "BatchedVO": lambda **kw: BatchedVO(K, num_features=64, **kw),
    "CompiledVO": lambda **kw: CompiledVO(K, num_features=64, **kw),
    "MonoVO": lambda **kw: MonoVO(_cam(), num_features=64, **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_no_device_means_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cpu_when_asked(name):
    assert ENTRY_POINTS[name](device="cpu") is not None


def test_default_device_resolution():
    assert default_device("cpu") == torch.device("cpu")
    assert default_device(torch.device("cpu")) == torch.device("cpu")
    if torch.cuda.is_available():
        assert default_device() == torch.device("cuda")
