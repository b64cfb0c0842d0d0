"""Small helpers over nested NamedTuples, tuples, lists and dicts of tensors
(the JAX package's ``jax.tree.map`` and ``jax.device_get``).

``to_host`` starts every device->host copy into pinned memory without
waiting and synchronises once at the end, so a whole structure costs one
host synchronisation, not one per leaf. ``to_device`` uploads numpy arrays
through pinned memory without waiting.
"""
from __future__ import annotations

import numpy as np
import torch


def as_numpy(x) -> np.ndarray:
    """One leaf as a numpy array (a tensor is copied to the host)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf (anything that is not a tuple, list or
    dict; ``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def to_host(tree):
    """Every tensor leaf as a numpy array, with one synchronisation for all
    the CUDA leaves together; other leaves pass through."""
    synced = []

    def start(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if x.device.type != "cuda":
            return x.cpu()
        dst = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        dst.copy_(x, non_blocking=True)
        synced.append(x.device)
        return dst

    started = tree_map(start, tree)
    for dev in set(synced):
        torch.cuda.current_stream(dev).synchronize()
    return tree_map(lambda x: x.numpy() if isinstance(x, torch.Tensor) else x, started)


def to_device(tree, device):
    """Every numpy or tensor leaf as a tensor on ``device``; uploads to a
    CUDA device go through pinned memory without waiting."""
    device = torch.device(device) if device is not None else torch.device("cpu")

    def up(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if not isinstance(x, torch.Tensor):
            return x
        if device.type == "cuda" and x.device.type == "cpu":
            return x.pin_memory().to(device, non_blocking=True)
        return x.to(device)

    return tree_map(up, tree)
