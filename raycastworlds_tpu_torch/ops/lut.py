"""LUT row lookup.  The JAX package writes it as a one-hot matmul because a
gather is slow on a TPU; on a GPU it is an index select, and exact."""

from __future__ import annotations

import torch


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: table [N, ...], idx int[...] -> [*idx.shape, ...]."""
    return table[idx.to(torch.int64)]
