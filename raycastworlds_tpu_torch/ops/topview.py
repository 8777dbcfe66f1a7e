"""Top-view (bird's-eye) renderer, batched over envs: the debug view.

The tile map as filled rectangles with 1-px grid lines, one ray segment from
the player to each hit point, and the player circle, in the JAX package's
draw order and pixel rules (``ops/topview.py`` there): integer Bresenham
segments, the hit-axis endpoint from integer hit data, and circles as bands
of the rounded pixel distance.  Images are built in int32 (every colour is
below 2**24); :func:`render_top_view` returns them as a ``torch.uint32``
view.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from .. import colors
from ..config import EnvConfig
from .raycast import RayHits
from .render import goal_tile_map, sqrt_f32
from .units import wu_to_pu


def _bresenham_steps(p0: torch.Tensor, p1: torch.Tensor, max_len: int
                     ) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The ``max_len`` steps of :func:`bresenham_points`, one (x, y, valid)
    of int32[...], int32[...], bool[...] at a time."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x, y = p0[..., 0], p0[..., 1]
    dx = torch.abs(x1 - x)
    dy = -torch.abs(y1 - y)
    sx = torch.where(x < x1, 1, -1).to(torch.int32)
    sy = torch.where(y < y1, 1, -1).to(torch.int32)
    err = dx + dy
    alive = torch.ones_like(x, dtype=torch.bool)
    for _ in range(max_len):
        yield x, y, alive
        at_end = (x == x1) & (y == y1)
        e2 = 2 * err
        step_x = (e2 >= dy) & alive & ~at_end
        step_y = (e2 <= dx) & alive & ~at_end
        err = err + torch.where(step_x, dy, 0) + torch.where(step_y, dx, 0)
        x = x + torch.where(step_x, sx, 0)
        y = y + torch.where(step_y, sy, 0)
        alive = alive & ~at_end


def bresenham_points(
    p0: torch.Tensor, p1: torch.Tensor, max_len: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer Bresenham points of a batch of segments.

    p0, p1: int32[..., 2] endpoints (inclusive).  Returns (points
    int32[L, ..., 2], valid bool[L, ...]) with L = ``max_len``; points past
    a segment's end are invalid.  The JAX package's ``lax.scan`` as a loop.
    """
    steps = list(_bresenham_steps(p0, p1, max_len))
    return (torch.stack([torch.stack([x, y], dim=-1) for x, y, _ in steps]),
            torch.stack([v for _, _, v in steps]))


def render_tile_blit(
    cfg: EnvConfig,
    wall_map: torch.Tensor,
    goal_tu: torch.Tensor,
    goal_map: Optional[torch.Tensor] = None,
    block_map: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """int32[B, H*ppt, W*ppt] tile rectangles and grid lines: wall white,
    goal red, empty black, blocks blue, a 1-px border around every tile.
    ``wall_map`` bool[B, H, W]; ``goal_map`` (bool[B, H, W]) replaces the
    single ``goal_tu`` tile (int32[B, 2]); ``block_map`` adds blue tiles
    where there is no wall."""
    ppt = cfg.pu_per_tu
    h, w = cfg.H, cfg.W
    dev = wall_map.device
    if goal_map is None:
        goal_map = goal_tile_map(goal_tu, (h, w))
    tile = torch.where(
        wall_map, colors.TILE_WALL, torch.where(goal_map, colors.TILE_GOAL, colors.TILE_EMPTY)
    ).to(torch.int32)
    if block_map is not None:
        tile = torch.where(block_map & ~wall_map, colors.TILE_BLOCK, tile).to(torch.int32)
    img = tile.repeat_interleave(ppt, dim=1).repeat_interleave(ppt, dim=2)
    pi = torch.arange(h * ppt, device=dev) % ppt
    pj = torch.arange(w * ppt, device=dev) % ppt
    line = ((pi[:, None] == 0) | (pi[:, None] == ppt - 1)
            | (pj[None, :] == 0) | (pj[None, :] == ppt - 1))
    return torch.where(line[None], colors.GRID_LINE, img).to(torch.int32)


def _rounded_distance(hpu: int, wpu: int, center_px: torch.Tensor) -> torch.Tensor:
    """int32[..., hpu, wpu]: ``round(sqrt(float32(di^2 + dj^2)))`` from each
    pixel to ``center_px`` (int32[..., 2]); round half to even, as
    ``jnp.round``."""
    dev = center_px.device
    di = torch.arange(hpu, dtype=torch.int32, device=dev)[:, None] - center_px[..., 0, None, None]
    dj = torch.arange(wpu, dtype=torch.int32, device=dev)[None, :] - center_px[..., 1, None, None]
    d = sqrt_f32((di * di + dj * dj).to(torch.float32))
    return torch.round(d).to(torch.int32)


def render_top_view(
    cfg: EnvConfig,
    wall_map: torch.Tensor,
    goal_tu: torch.Tensor,
    pos_wu: torch.Tensor,
    player_radius_pu: int,
    hits: RayHits,
    goal_map: Optional[torch.Tensor] = None,
    block_map: Optional[torch.Tensor] = None,
    others_pu: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """uint32[B, H*ppt, W*ppt] top views: the tile blit, then the ray
    segments from ``pos_wu`` (f32[B, 2]) to each hit of ``hits`` ([B, R]),
    then ``others_pu`` (int32[B, K, 2], optional) as filled circles of the
    player radius in the block colour, then the player circle on top."""
    ppt = cfg.pu_per_tu
    hpu, wpu = cfg.top_view_shape
    b = pos_wu.shape[0]
    img = render_tile_blit(cfg, wall_map, goal_tu, goal_map, block_map)

    # Ray segments.  The hit-axis coordinate of the endpoint is a grid line
    # (the entered face of the hit tile), taken from integer hit data; only
    # the cross-axis coordinate is a float, ``pos + dist*dir`` rounded twice.
    p_px = wu_to_pu(pos_wu, ppt)                                   # [B, 2]
    face = torch.where(hits.ray_dirs >= 0, hits.hit_tu, hits.hit_tu + 1)
    cross_px = wu_to_pu(pos_wu[:, None, :] + hits.dist_wu[..., None] * hits.ray_dirs, ppt)
    is_axis = torch.arange(2, device=pos_wu.device) == hits.hit_dim[..., None]
    stop_px = torch.where(is_axis, face * ppt, cross_px).to(torch.int32)  # [B, R, 2]
    p0 = p_px[:, None, :].expand_as(stop_px)
    # A segment has max(|dx|, |dy|) + 1 points: march only as far as the
    # longest one needs (the JAX scan's hpu + wpu steps at most).  Every
    # point writes the same colour, so each step scatters straight into the
    # image; out-of-range points go to a sentinel slot past its end, dropped
    # with it (never -1, which would wrap).
    span = int((stop_px - p0).abs().amax()) + 1
    flat = torch.cat([img.reshape(b, -1), img.new_zeros(b, 1)], dim=1)
    for x, y, valid in _bresenham_steps(p0, stop_px, min(span, hpu + wpu)):
        inb = valid & (x >= 0) & (x < hpu) & (y >= 0) & (y < wpu)
        idx = torch.where(inb, x * wpu + y, hpu * wpu).to(torch.int64)  # [B, R]
        flat.scatter_(1, idx, colors.RAY)
    img = flat[:, : hpu * wpu].reshape(b, hpu, wpu)

    if others_pu is not None:
        od = _rounded_distance(hpu, wpu, others_pu)                # [B, K, hpu, wpu]
        filled = (od <= player_radius_pu).any(dim=1)
        img = torch.where(filled, colors.TILE_BLOCK, img).to(torch.int32)

    on_circle = _rounded_distance(hpu, wpu, p_px) == player_radius_pu
    return torch.where(on_circle, colors.PLAYER, img).to(torch.int32).view(torch.uint32)
