"""Row selection that keeps leading batch dimensions (the batched VO step
indexes each sequence's rows with that sequence's indices)."""
from __future__ import annotations

import torch


def take_rows(x: torch.Tensor, idx: torch.Tensor, nb: int) -> torch.Tensor:
    """``x[idx]`` per batch element: ``x`` (*batch, N, *feat) and integer
    ``idx`` (*batch, *I) share their ``nb`` leading batch dimensions ->
    (*batch, *I, *feat). With ``nb`` = 0 this is plain ``x[idx]``."""
    if nb == 0:
        return x[idx]
    batch, feat = x.shape[:nb], x.shape[nb + 1:]
    flat = idx.reshape(*batch, -1)
    rows = x.gather(nb, flat.reshape(flat.shape + (1,) * len(feat)).expand(*flat.shape, *feat))
    return rows.reshape(*idx.shape, *feat)
