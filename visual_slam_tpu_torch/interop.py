"""Carry tracking state across from the JAX package, as numpy arrays.

The system has no weights: what carries over is the state (reference
features, landmarks, poses, the arena) and the constants, which the port
builds from the same seeds. Descriptor words are ``uint32`` in the JAX
package and ``int32`` here, bit for bit (``ndarray.view``). Nothing here
imports JAX: the arguments are any objects with the JAX fields, holding
numpy arrays (or anything ``np.asarray`` reads).
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.detector import Features
from .pipeline import TrackState


def desc_to_int32(desc) -> np.ndarray:
    """uint32 descriptor words -> the same bits as int32."""
    return np.array(desc, dtype=np.uint32).view(np.int32)


def desc_to_uint32(desc: torch.Tensor) -> np.ndarray:
    """The port's int32 descriptor words -> the JAX package's uint32 bits."""
    return np.ascontiguousarray(desc.detach().cpu().numpy()).view(np.uint32)


def features_from_numpy(feats, device=None) -> Features:
    """The port's ``Features`` on ``device`` from an object with the JAX
    ``Features`` fields."""

    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype).to(device)

    return Features(
        xy=t(feats.xy, torch.float32),
        response=t(feats.response, torch.float32),
        angle=t(feats.angle, torch.float32),
        octave=t(feats.octave, torch.int32),
        size=t(feats.size, torch.float32),
        desc=torch.from_numpy(desc_to_int32(feats.desc)).to(device),
        valid=t(feats.valid, torch.bool),
    )


def track_state_from_numpy(state, device=None, seed: int = 0) -> TrackState:
    """The port's ``TrackState`` on ``device`` from the leaves of a JAX
    ``TrackState``. The JAX PRNG key does not carry over: RANSAC draws come
    from a new generator seeded with ``seed``."""

    def t(x, dtype):
        return None if x is None else torch.tensor(np.asarray(x), dtype=dtype).to(device)

    device = torch.device(device) if device is not None else torch.device("cpu")
    return TrackState(
        ref_feats=features_from_numpy(state.ref_feats, device),
        ref_landmarks=t(state.ref_landmarks, torch.float32),
        ref_has_landmark=t(state.ref_has_landmark, torch.bool),
        T_w2c=t(state.T_w2c, torch.float32),
        T_rel=t(state.T_rel, torch.float32),
        gen=torch.Generator(device=device).manual_seed(seed),
        lm_pos=t(state.lm_pos, torch.float32),
        lm_desc=None if state.lm_desc is None else torch.from_numpy(desc_to_int32(state.lm_desc)).to(device),
        lm_valid=t(state.lm_valid, torch.bool),
    )
