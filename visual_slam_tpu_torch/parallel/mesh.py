"""Device meshes (port of ``visual_slam_tpu.parallel.mesh``)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..utils.device import default_device


class Mesh(NamedTuple):
    """An n-dimensional array of devices with one name per axis, as
    ``jax.sharding.Mesh`` holds them."""

    devices: np.ndarray  # of torch.device
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(axis_names=("seq", "lm"), shape=None, devices=None) -> Mesh:
    """A mesh over ``devices`` (the card unless the caller names them).

    The default factorization puts sequences (data parallel) on the first
    axis and landmark shards on the second; with a single axis name the
    mesh is 1-D over all devices."""
    devices = list(devices) if devices is not None else [default_device()]
    n = len(devices)
    if isinstance(axis_names, str):
        axis_names = (axis_names,)
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        else:
            a = next(f for f in range(int(np.sqrt(n)), 0, -1) if n % f == 0)
            shape = (a, n // a) + (1,) * (len(axis_names) - 2)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), tuple(axis_names))
