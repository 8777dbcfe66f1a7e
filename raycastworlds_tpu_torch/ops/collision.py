"""Circle-vs-AABB collision, batched over envs.

Tile ``(i, j)`` is the unit AABB centered at ``(i+0.5, j+0.5)``.  The player
circle of radius ``r`` collides with it iff the squared distance from the
circle center to its clamp-projection onto the AABB is ``< r^2``.  A
collision test reads the fixed 3x3 neighbourhood of the player's tile.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bitmap
from .units import wu_to_tu

# Static 3x3 neighbourhood offsets, in the JAX package's order.
_OFFS = np.stack(
    np.meshgrid(np.arange(-1, 2), np.arange(-1, 2), indexing="ij"), axis=-1
).reshape(9, 2)


def _radius_sq(radius, dtype: torch.dtype) -> float:
    """``radius`` rounded to ``dtype`` (float32 or float64), squared there."""
    r = (np.float64 if dtype == torch.float64 else np.float32)(radius)
    return float(r * r)


def is_colliding_tile(
    pos_wu: torch.Tensor, tile_tu: torch.Tensor, radius
) -> torch.Tensor:
    """Circle at ``pos_wu`` (f[..., 2]) vs unit AABB at ``tile_tu``
    (i32[..., 2]) -> bool[...]; the radius squared in ``pos_wu``'s dtype."""
    center = tile_tu.to(pos_wu.dtype) + 0.5
    rel = pos_wu - center
    proj = torch.clamp(rel, -0.5, 0.5)
    e = rel - proj
    sq = e * e
    d2 = sq[..., 0] + sq[..., 1]
    return d2 < _radius_sq(radius, pos_wu.dtype)


def _neighbourhood(pos_wu: torch.Tensor, shape):
    """(neigh i32[B, 9, 2], clipped bit index i32[B, 9])."""
    h, w = shape
    tile = wu_to_tu(pos_wu)                                    # [B, 2]
    offs = torch.as_tensor(_OFFS, dtype=torch.int32, device=pos_wu.device)
    neigh = tile[:, None, :] + offs[None, :, :]                # [B, 9, 2]
    ni = torch.clamp(neigh[..., 0], 0, h - 1)
    nj = torch.clamp(neigh[..., 1], 0, w - 1)
    return neigh, ni * w + nj


def is_player_colliding(
    obstacle_map: torch.Tensor, pos_wu: torch.Tensor, radius
) -> torch.Tensor:
    """bool[]: the player circle at ``pos_wu`` (f[2], one env) overlaps an
    occupied tile of the dense ``obstacle_map`` (bool[H, W]) in its tile's
    3x3 neighbourhood; the gathers clamp at the map's edge."""
    h, w = obstacle_map.shape
    neigh, idx = _neighbourhood(pos_wu[None], (h, w))          # [1, 9, 2], [1, 9]
    occupied = obstacle_map.reshape(-1)[idx[0].to(torch.int64)]
    hit = is_colliding_tile(pos_wu[None, :], neigh[0], radius)
    return (occupied & hit).any()


def is_player_colliding_packed(
    obstacle_words: torch.Tensor, shape, pos_wu: torch.Tensor, radius
) -> torch.Tensor:
    """bool[B]: the player circle overlaps an occupied tile of its 3x3
    neighbourhood.  ``obstacle_words`` int32[B, nw], ``pos_wu`` f32[B, 2]."""
    neigh, idx = _neighbourhood(pos_wu, shape)
    occupied = bitmap.lookup_bit(obstacle_words, idx)          # [B, 9]
    hit = is_colliding_tile(pos_wu[:, None, :], neigh, radius)
    return (occupied & hit).any(dim=-1)


def colliding_occupied_words(
    occupied_words: torch.Tensor, shape, pos_wu: torch.Tensor, radius
) -> torch.Tensor:
    """int32[B, nw] mask of the occupied tiles the player circle overlaps
    (same neighbourhood scan as :func:`is_player_colliding_packed`)."""
    nw = occupied_words.shape[-1]
    neigh, idx = _neighbourhood(pos_wu, shape)
    occupied = bitmap.lookup_bit(occupied_words, idx)
    active = occupied & is_colliding_tile(pos_wu[:, None, :], neigh, radius)
    # OR of one-hot words (clipping at the map edge can repeat a tile, so
    # a sum would carry).
    word_sel = (idx[..., None] >> 5) == torch.arange(
        nw, dtype=torch.int32, device=idx.device
    )                                                          # [B, 9, nw]
    bit = torch.ones_like(idx) << (idx & 31)                   # [B, 9]
    contrib = torch.where(word_sel & active[..., None], bit[..., None], 0)
    out = contrib[:, 0]
    for q in range(1, contrib.shape[1]):
        out = out | contrib[:, q]
    return out


def is_colliding_with_goal(
    pos_wu: torch.Tensor, goal_tu: torch.Tensor, radius
) -> torch.Tensor:
    """The goal is one tile, so the goal-channel 3x3 scan is one circle/AABB
    test (any farther tile cannot collide since radius < 0.5)."""
    return is_colliding_tile(pos_wu, goal_tu, radius)
