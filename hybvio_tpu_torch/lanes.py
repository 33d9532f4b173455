"""Per-lane selection: the batch-first form of a ``lax.cond`` under
``vmap``, which computes both branches and selects per sequence."""
from __future__ import annotations

import torch


def lane_where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` where the lane's ``cond`` (B,) holds, else ``b`` (both (B, ...))."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim())), a, b)


def tuple_where(cond: torch.Tensor, new, old):
    """``lane_where`` over every field of two NamedTuples of one type."""
    return type(old)(*(lane_where(cond, n, o) for n, o in zip(new, old)))
