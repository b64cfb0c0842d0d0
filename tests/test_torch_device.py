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
from visual_slam_tpu_torch.models import CompiledSLAM
from visual_slam_tpu_torch.pipeline import make_track_step
from visual_slam_tpu_torch.utils.device import default_device

K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])

ENTRY_POINTS = {
    "CompiledSLAM": lambda **kw: CompiledSLAM(PinholeCamera(width=320, height=240, K=K), Config(), **kw),
    "make_track_step": lambda **kw: make_track_step(K, num_features=64, **kw),
    "FeatureTracker": lambda **kw: FeatureTracker(Config().feature, **kw),
    "FastOrbFeature2D": lambda **kw: FastOrbFeature2D(num_features=64, **kw),
    "LMOptimizer": lambda **kw: LMOptimizer(Config(), PinholeCamera(width=320, height=240, K=K), **kw),
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
