"""Closed-form raycaster for room-shaped maps (border ring + K unit boxes),
batched over ``[B, R, K]``.

The first occupied tile along an interior ray is either the border wall
whose inner face the ray crosses first, at ``t = (face - origin) / dir`` on
the nearer axis, or the nearest of K unit boxes by slab (ray-vs-AABB)
tests, whichever is closer.  Backend ``analytic`` of the families whose map
is exactly that (SingleRoom, MultiGoalRoom, DynamicRoom).

Numerics: the JAX package's own contract for this backend is hit tiles and
faces of the DDA and distances to ~1e-6 relative, not bit-exactness.  The
port evaluates the same expressions with one rounding per op; XLA on the CPU
contracts the wall crossing ``p + t*d`` into an FMA, so the two can floor
to different wall tiles when the crossing lies within an ulp of a grid line.
"""

from __future__ import annotations

import torch

from ..config import EnvConfig
from . import lut
from .raycast import RayHits


def cast_rays_boxes(
    cfg: EnvConfig,
    boxes_tu: torch.Tensor,   # i32[B, K, 2]
    pos_wu: torch.Tensor,     # f[B, 2] (float32, or float64 in a float64 world)
    ray_dirs: torch.Tensor,   # f[B, R, 2], the same dtype
) -> RayHits:
    """First hit of every ray against the border ring and the K unit boxes
    of its env.  Box rows outside the interior (e.g. (-1, -1) for collected
    goals) never beat the border and act as disabled slots."""
    h, w = cfg.H, cfg.W
    dev = pos_wu.device
    dx, dy = ray_dirs[..., 0], ray_dirs[..., 1]              # [B, R]
    px, py = pos_wu[:, 0:1], pos_wu[:, 1:2]                  # [B, 1]
    fc = lambda v: torch.tensor(float(v), dtype=ray_dirs.dtype, device=dev)  # noqa: E731
    inf = fc("inf")

    # border walls: inner faces at i = 1 / H-1 and j = 1 / W-1
    face_i = torch.where(dx > 0, fc(h - 1), fc(1))
    face_j = torch.where(dy > 0, fc(w - 1), fc(1))
    t_i = torch.where(dx != 0, (face_i - px) / dx, inf)
    t_j = torch.where(dy != 0, (face_j - py) / dy, inf)
    wall_dim = torch.where(t_i < t_j, 0, 1).to(torch.int32)
    t_wall = torch.minimum(t_i, t_j)
    # the wall tile: one step into the ring at the crossing point
    cross_i = torch.floor(px + t_wall * dx).to(torch.int32)
    cross_j = torch.floor(py + t_wall * dy).to(torch.int32)
    wi = torch.where(wall_dim == 0, torch.where(dx > 0, h - 1, 0), cross_i)
    wj = torch.where(wall_dim == 1, torch.where(dy > 0, w - 1, 0), cross_j)
    wi = torch.clamp(wi, 0, h - 1)
    wj = torch.clamp(wj, 0, w - 1)

    # K unit boxes: slab test on [gi, gi+1] x [gj, gj+1], as [B, R, K]
    g0 = boxes_tu.to(ray_dirs.dtype)[:, None, :, :]          # [B, 1, K, 2]
    g1 = g0 + 1.0
    dxk, dyk = dx[..., None], dy[..., None]                  # [B, R, 1]
    pxk, pyk = px[..., None], py[..., None]                  # [B, 1, 1]

    def slab(g, p, d, below_is_entry):
        # dir == 0: the slab holds the origin or it does not (+/-inf order)
        side = (p >= g) if below_is_entry else (p <= g)
        flat = torch.where(side, -inf if below_is_entry else inf,
                           inf if below_is_entry else -inf)
        return torch.where(d != 0, (g - p) / d, flat)

    tx1 = slab(g0[..., 0], pxk, dxk, True)
    tx2 = slab(g1[..., 0], pxk, dxk, False)
    ty1 = slab(g0[..., 1], pyk, dyk, True)
    ty2 = slab(g1[..., 1], pyk, dyk, False)
    tx_in, tx_out = torch.minimum(tx1, tx2), torch.maximum(tx1, tx2)
    ty_in, ty_out = torch.minimum(ty1, ty2), torch.maximum(ty1, ty2)
    t_enter = torch.maximum(tx_in, ty_in)
    t_exit = torch.minimum(tx_out, ty_out)
    box_hit = (t_enter > 0) & (t_enter <= t_exit)
    box_dim = torch.where(tx_in >= ty_in, 0, 1).to(torch.int32)
    t_box = torch.where(box_hit, t_enter, inf)               # [B, R, K]

    # the first nearest box (argmin's tie rule)
    k = boxes_tu.shape[1]
    t_best = torch.amin(t_box, dim=-1)                       # [B, R]
    kk = torch.arange(k, device=dev)
    best = torch.where(t_box == t_best[..., None], kk, k).amin(dim=-1)
    best = torch.clamp(best, max=k - 1)[..., None].to(torch.int64)
    dim_best = torch.gather(box_dim, -1, best)[..., 0]
    rows = boxes_tu.to(torch.int64)
    bi = torch.gather(rows[..., 0], 1, best[..., 0]).to(torch.int32)
    bj = torch.gather(rows[..., 1], 1, best[..., 0]).to(torch.int32)

    use_box = t_best < t_wall
    dist = torch.where(use_box, t_best, t_wall)
    hit_dim = torch.where(use_box, dim_best, wall_dim)
    hit_i = torch.where(use_box, bi, wi)
    hit_j = torch.where(use_box, bj, wj)
    return RayHits(ray_dirs=ray_dirs, hit_tu=torch.stack([hit_i, hit_j], dim=-1),
                   hit_dim=hit_dim, dist_wu=dist)


def cast_rays_analytic(
    cfg: EnvConfig,
    goal_tu: torch.Tensor,    # i32[2]
    pos_wu: torch.Tensor,     # f32[2]
    dir_au: torch.Tensor,     # i32[]
) -> RayHits:
    """The border ring plus one goal box (SingleRoom), for one env: the
    heading's fan from ``cfg.ray_fan_lut``; ``RayHits`` of [R, ...]."""
    dirs = lut.take_rows(torch.as_tensor(cfg.ray_fan_lut, device=pos_wu.device), dir_au)
    hits = cast_rays_boxes(cfg, goal_tu[None, None, :], pos_wu[None], dirs[None])
    return RayHits(*(x[0] for x in hits))
