"""Data-parallel multi-sequence visual odometry (port of
``visual_slam_tpu.parallel.multiseq``).

BASELINE.json config 5 ("4 KITTI sequences SLAM'd in parallel"): one
tracking step (pipeline.py) carries B independent sequences. The JAX
package ``vmap``s the step and lets XLA add a batch axis to every kernel;
here the step takes a leading B itself (``TrackStep.forward``), so each
hand-written kernel (K1, K2, and K3 with the local map) launches once per
batched step for all B, and the host issues the same launches for B
sequences as for one. The batch lives on one card: a mesh of more than one
device is ROADMAP M14.
"""
from __future__ import annotations

import torch

from ..pipeline import TrackOutput, TrackState, TrackStep, make_track_step
from ..utils.tree import to_device
from .mesh import Mesh


def _mesh_device(mesh: Mesh, axis: str) -> torch.device:
    """The one device of ``mesh``; more than one raises (ROADMAP M14)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has no axis {axis!r} (axes {mesh.axis_names})")
    if mesh.size != 1:
        raise NotImplementedError(f"a mesh of {mesh.size} devices: sharding the batch over more than one device "
                                  "is not ported yet (ROADMAP M14)")
    return torch.device(mesh.devices.flat[0])


def batched_track_step(track_step: TrackStep):
    """``(states, imgs (B, H, W)) -> (states, outs)`` over a batched state
    (``pipeline.stack_track_states``): the step with every leaf and output
    on a leading B. A stereo step takes (B, 2, H, W) pairs and detects all
    2B frames in one K1 launch."""
    frame_dims = 4 if track_step.stereo else 3
    shape = "(B, 2, H, W) pairs" if track_step.stereo else "(B, H, W) frames"

    def step(states: TrackState, imgs: torch.Tensor) -> tuple[TrackState, TrackOutput]:
        if imgs.dim() != frame_dims or len(states.gen) != imgs.shape[0]:
            raise ValueError(f"a batched step takes {shape} and B generators; got {tuple(imgs.shape)} and "
                             f"{len(states.gen)} generators")
        return track_step(states, imgs)

    return step


def make_batched_vo(K, mesh: Mesh | None = None, axis: str = "seq", device=None, **track_params):
    """The batched VO step ``(states, imgs) -> (states, outs)`` on the one
    device of ``mesh`` or on ``device`` (the card unless the caller asks
    for the CPU); keyword arguments as ``TrackStep``."""
    if mesh is not None:
        device = _mesh_device(mesh, axis)
    return batched_track_step(make_track_step(K, device=device, **track_params))


def shard_batch(mesh: Mesh, axis: str, tree):
    """Place a batched structure (states, frames) on the mesh: its tensor
    leaves move to the mesh's one device; generators stay as they are."""
    return to_device(tree, _mesh_device(mesh, axis))
