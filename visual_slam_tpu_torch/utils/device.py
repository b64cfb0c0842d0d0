"""The device an entry point runs on when the caller names none."""
from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card (``"cuda"``).
    Without a CUDA device ``None`` raises: the CPU runs only when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the port runs on the card by default; pass device="cpu" to run on the CPU')
    return torch.device("cuda")
