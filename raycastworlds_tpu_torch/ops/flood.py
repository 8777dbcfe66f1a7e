"""Reachability by iterated 4-neighbour dilation, batched over envs.

A fixed trip count (``H*W//2 + 2`` unless given) bounds every shortest path
on an H x W grid.  The loop never exits early: testing for a fixed point
would read the device from the host once per iteration.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import profiling


def dilate4(mask: torch.Tensor) -> torch.Tensor:
    """4-neighbour binary dilation of bool[B, H, W] (outside is False)."""
    out = mask.clone()
    out[:, :-1, :] |= mask[:, 1:, :]
    out[:, 1:, :] |= mask[:, :-1, :]
    out[:, :, :-1] |= mask[:, :, 1:]
    out[:, :, 1:] |= mask[:, :, :-1]
    return out


@profiling.span("rcw.ops.flood_fill")
def flood_fill(
    passable: torch.Tensor, seed_tu: torch.Tensor, num_iters: Optional[int] = None
) -> torch.Tensor:
    """Tiles of ``passable`` (bool[B, H, W]) reachable from ``seed_tu``
    (i32[B, 2]) under 4-connectivity, after ``num_iters`` dilations
    (counted as ``flood_dilations``)."""
    _, h, w = passable.shape
    if num_iters is None:
        num_iters = h * w // 2 + 2
    profiling.count("flood_dilations", num_iters)
    ii = torch.arange(h, device=passable.device)[None, :, None]
    jj = torch.arange(w, device=passable.device)[None, None, :]
    seed = (ii == seed_tu[:, 0, None, None]) & (jj == seed_tu[:, 1, None, None])
    reach = seed & passable
    for _ in range(num_iters):
        reach = dilate4(reach) & passable
    return reach
