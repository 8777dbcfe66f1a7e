"""The crossing raycaster in plain PyTorch, batched over ``[B, R]``.

A ray leaving ``p`` along ``d`` crosses at most H i-lines and W j-lines
before the border walls stop it; crossing k of an axis enters exactly one
tile at the closed-form distance ``t = (frac + k) / |d|``.  The hit is the
smallest crossing distance whose entered tile is occupied.  Every candidate
of every ray is evaluated at once as ``[B, N, R]`` tensors and reduced with
a (t, k) lexicographic min.

This is the plain ``crossing`` backend and the parity reference of the JAX
package's ``ops/raycast.cast_rays_crossing``: the same float32 expressions,
tie rules and clip-and-mask handling.  ``t`` is add-then-divide (one
correctly rounded division, never a contractible mul+add); the cross
coordinate ``p + t*d`` is two eager ops, so it rounds twice.  The plain
casts (crossing and scan) also take float64 positions and rays (a float64
world), where a miss is the largest float64; the kernels take float32 only.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ..config import EnvConfig
from . import bitmap


def _big(x: torch.Tensor) -> float:
    """The miss distance: the largest value of ``x``'s float dtype."""
    return float(torch.finfo(x.dtype).max)


class RayHits(NamedTuple):
    """Per-ray cast results (f: float32, or float64 in a float64 world)."""

    ray_dirs: torch.Tensor  # f[B, R, 2] normalized ray directions
    hit_tu: torch.Tensor    # i32[B, R, 2] hit tile
    hit_dim: torch.Tensor   # i32[B, R]    0 = i-face, 1 = j-face
    dist_wu: torch.Tensor   # f[B, R]      distance along the ray to the face


def ray_fan(cfg: EnvConfig, player_dir_wu: torch.Tensor) -> torch.Tensor:
    """Normalized ray directions f[B, R, 2] of heading vectors f[B, 2], the
    live formula of continuous headings: the rays lerp across the camera
    plane from ``dir + sfov*cam`` to ``dir - sfov*cam`` with ``cam`` the
    heading turned by -90 degrees, then normalize.  Every product and sum
    rounds on its own (the discrete headings' ``ray_fan_lut`` is this
    formula in float64, cast once); the norm's square root is correctly
    rounded."""
    from .render import sqrt_of

    d = player_dir_wu
    dt = d.dtype
    cam = torch.stack([d[:, 1], -d[:, 0]], dim=-1)
    s = torch.tensor(cfg.semi_field_of_view_wu, dtype=dt, device=d.device)
    first = d + s * cam
    last = d - s * cam
    r = cfg.num_rays
    t = torch.arange(r, dtype=dt, device=d.device) / torch.tensor(
        float(r - 1), dtype=dt, device=d.device)
    un = first[:, None, :] + t[None, :, None] * (last - first)[:, None, :]   # [B, R, 2]
    norm = sqrt_of(un[..., 0] * un[..., 0] + un[..., 1] * un[..., 1])
    return un / norm[..., None]


def _crossing_axis(
    shape: Tuple[int, int],
    d_main: torch.Tensor,    # f32[B, R] direction component along the crossed axis
    d_cross: torch.Tensor,   # f32[B, R] the other component
    p_main: torch.Tensor,    # f32[B, 1] origin along the crossed axis
    p_cross: torch.Tensor,   # f32[B, 1] origin along the other axis
    main_is_i: bool,
    line_words: List[torch.Tensor],  # per 32-tile word q: i32[B, size_main]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All grid-line crossings of one axis.

    Returns (best_t f32[B, R], main_tile i32[B, R], cross_tile i32[B, R]):
    the smallest crossing distance whose entered tile is occupied, or the
    largest float when no crossing of this axis hits.
    """
    h, w = shape
    dev = d_main.device
    n = h if main_is_i else w
    size_main = n
    size_cross = w if main_is_i else h

    fl = torch.floor(p_main)
    main0 = fl.to(torch.int32)                                   # [B, 1]
    neg = d_main < 0
    step = torch.where(neg, -1, 1).to(torch.int32)               # [B, R]
    frac = p_main - fl
    frac_sel = torch.where(neg, frac, 1.0 - frac)                # [B, R]
    ad = torch.abs(d_main)

    k = torch.arange(n, dtype=d_main.dtype, device=dev)          # [N]
    t = (frac_sel[:, None, :] + k[None, :, None]) / ad[:, None, :]  # [B, N, R]
    finite = torch.isfinite(t)
    c = p_cross[:, :, None] + t * d_cross[:, None, :]
    c = torch.where(finite, c, 0.0)
    # Entered tile on the crossed axis is exact integer arithmetic; the
    # cross-axis tile replays the sequential march's tie rule (ties advance
    # j first): at an i-crossing a simultaneous j-crossing has advanced
    # (floor for dy >= 0, ceil-1 for dy < 0; dy == 0 slides on the line and
    # keeps floor); at a j-crossing a simultaneous i-crossing has not
    # (ceil-1 for dx > 0, floor otherwise).
    dc = d_cross[:, None, :]
    if main_is_i:
        c_tile = torch.where(dc >= 0, torch.floor(c), torch.ceil(c) - 1.0)
    else:
        c_tile = torch.where(dc > 0, torch.ceil(c) - 1.0, torch.floor(c))
    c_idx = torch.clamp(c_tile, 0.0, float(size_cross - 1)).to(torch.int32)

    # The crossed line depends on the ray only through the step sign, so the
    # candidate's line word is one of two per-env rows.
    ks = torch.arange(1, n + 1, dtype=torch.int32, device=dev)[None, :]
    m_plus = torch.clamp(main0 + ks, 0, size_main - 1).to(torch.int64)   # [B, N]
    m_minus = torch.clamp(main0 - ks, 0, size_main - 1).to(torch.int64)
    step_pos = (step > 0)[:, None, :]
    bit = c_idx & 31
    occ = None
    for q, lw in enumerate(line_words):
        w_plus = torch.gather(lw, 1, m_plus)[:, :, None]         # [B, N, 1]
        w_minus = torch.gather(lw, 1, m_minus)[:, :, None]
        word = torch.where(step_pos, w_plus, w_minus)            # [B, N, R]
        hit_q = ((word >> bit) & 1) == 1
        if len(line_words) > 1:
            hit_q = hit_q & ((c_idx >> 5) == q)
        occ = hit_q if occ is None else occ | hit_q
    occ = occ & finite
    t_m = torch.where(occ, t, _big(t))                           # [B, N, R]

    # (t, k) lexicographic min: the smallest t, and among equal t the
    # smallest k.  An axis with no hit selects k = 0, as the JAX reduce
    # (initial k = n) does.
    best = torch.amin(t_m, dim=1)                                # [B, R]
    kk = torch.arange(n, dtype=torch.int32, device=dev)[None, :, None]
    kb = torch.where(t_m == best[:, None, :], kk, n).amin(dim=1)  # [B, R]
    c_best = torch.gather(c_idx, 1, kb[:, None, :].to(torch.int64))[:, 0, :]
    m_best = main0 + (kb + 1) * step
    return best, m_best, c_best


def _row_line_words(dense: torch.Tensor) -> List[torch.Tensor]:
    """Per-row occupancy words of dense int32 0/1 maps [B, H, W]: a list of
    ceil(W/32) tensors i32[B, H], word q bit j%32 = tile (i, 32q + j%32)."""
    w = dense.shape[-1]
    out = []
    for q in range(0, w, 32):
        cols = dense[:, :, q : min(q + 32, w)]
        sh = torch.arange(cols.shape[-1], dtype=torch.int32, device=dense.device)
        out.append((cols << sh).sum(dim=-1, dtype=torch.int32))
    return out


def _col_line_words(dense: torch.Tensor) -> List[torch.Tensor]:
    """Per-column occupancy words: ceil(H/32) tensors i32[B, W], word q bit
    i%32 = tile (32q + i%32, j)."""
    h = dense.shape[-2]
    out = []
    for q in range(0, h, 32):
        rows = dense[:, q : min(q + 32, h), :]
        sh = torch.arange(rows.shape[-2], dtype=torch.int32, device=dense.device)
        out.append((rows << sh[:, None]).sum(dim=-2, dtype=torch.int32))
    return out


def cast_rays_crossing(
    obstacle_words: torch.Tensor,   # i32[B, NW]
    shape: Tuple[int, int],
    pos_wu: torch.Tensor,           # f32[B, 2]
    ray_dirs: torch.Tensor,         # f32[B, R, 2]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain crossing cast.  Returns (hit_tu i32[B, R, 2], hit_dim i32[B, R],
    dist f32[B, R]); cross-axis distance ties resolve to the j face."""
    h, w = shape
    dx = ray_dirs[..., 0]
    dy = ray_dirs[..., 1]
    px = pos_wu[:, 0:1]
    py = pos_wu[:, 1:2]
    dense = bitmap.unpack_bits(obstacle_words, (h, w)).to(torch.int32)
    ti, ii, ji = _crossing_axis(
        (h, w), dx, dy, px, py, True, _row_line_words(dense)
    )
    tj, jj, ij = _crossing_axis(
        (h, w), dy, dx, py, px, False, _col_line_words(dense)
    )
    use_j = tj <= ti
    dist = torch.where(use_j, tj, ti)
    hit_dim = use_j.to(torch.int32)
    hit_i = torch.where(use_j, ij, ii)
    hit_j = torch.where(use_j, jj, ji)
    return torch.stack([hit_i, hit_j], dim=-1), hit_dim, dist


def cast_rays_scan(
    obstacle_words: torch.Tensor,   # i32[B, NW]
    shape: Tuple[int, int],
    pos_wu: torch.Tensor,           # f32[B, 2]
    ray_dirs: torch.Tensor,         # f32[B, R, 2]
    max_steps: int,
    early_exit: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain DDA, all rays of all envs in lockstep for ``max_steps`` steps.
    Returns (hit_tu i32[B, R, 2], hit_dim i32[B, R], dist f32[B, R]).

    Lodev/Wolfenstein DDA, as the JAX package's ``cast_rays_scan``:
    ``delta = |1/d|`` is the ray length per unit axis step (+inf on an
    exact-zero component), ``side`` the ray length to the next grid line of
    each axis; each step advances the axis with the smaller side (a tie
    steps j) and the hit distance is that side before the step.  Hit rays
    freeze; rays that never hit march every step, and ``hit_tu`` is the
    final map position either way (dist the largest float on a miss).
    ``early_exit`` stops once every ray has hit (a host sync per step);
    frozen rays are no-ops, so the results are the same.

    ``delta`` divides a tensor of ones by ``d``: on CUDA torch computes
    ``1 / tensor`` and ``tensor / python float`` through a reciprocal.
    """
    h, w = shape
    dx = ray_dirs[..., 0]
    dy = ray_dirs[..., 1]
    px = pos_wu[:, 0:1]
    py = pos_wu[:, 1:2]
    fx = torch.floor(px)
    fy = torch.floor(py)
    map_i = fx.to(torch.int32).expand_as(dx)
    map_j = fy.to(torch.int32).expand_as(dy)
    ones = torch.ones_like(dx)
    delta_i = torch.abs(ones / dx)
    delta_j = torch.abs(ones / dy)
    step_i = torch.where(dx < 0, -1, 1).to(torch.int32)
    step_j = torch.where(dy < 0, -1, 1).to(torch.int32)
    frac_i = px - fx
    frac_j = py - fy
    side_i = torch.where(dx < 0, frac_i, 1.0 - frac_i) * delta_i
    side_j = torch.where(dy < 0, frac_j, 1.0 - frac_j) * delta_j

    hit = torch.zeros_like(dx, dtype=torch.bool)
    hit_dim = torch.zeros_like(dx, dtype=torch.int32)
    dist = torch.full_like(dx, _big(dx))
    for _ in range(max_steps):
        if early_exit and bool(hit.all()):
            break
        take_i = side_i < side_j
        adv = ~hit
        cross = torch.minimum(side_i, side_j)
        go_i = adv & take_i
        go_j = adv & ~take_i
        map_i = map_i + torch.where(go_i, step_i, 0)
        map_j = map_j + torch.where(go_j, step_j, 0)
        side_i = side_i + torch.where(go_i, delta_i, 0.0)
        side_j = side_j + torch.where(go_j, delta_j, 0.0)
        idx = torch.clamp(map_i, 0, h - 1) * w + torch.clamp(map_j, 0, w - 1)
        occ = bitmap.lookup_bit(obstacle_words, idx)
        newly = adv & occ
        hit = hit | occ
        hit_dim = torch.where(newly, torch.where(take_i, 0, 1), hit_dim).to(torch.int32)
        dist = torch.where(newly, cross, dist)
    return torch.stack([map_i, map_j], dim=-1), hit_dim, dist


def check_cast_inputs(obstacle_words, shape, pos_wu, ray_dirs) -> None:
    """Raise unless the kernels' batch cast contract holds: words i32[B, NW]
    packing an H x W map, pos f32[B, 2] and dirs f32[B, R, 2], on one
    device (the kernels refuse float64 input)."""
    h, w = shape
    if obstacle_words.dim() != 2 or pos_wu.dim() != 2 or ray_dirs.dim() != 3:
        raise ValueError("expected words [B, NW], pos [B, 2], dirs [B, R, 2]")
    b, nw = obstacle_words.shape
    if nw != bitmap.n_words(h * w):
        raise ValueError(f"{nw} words do not pack a {h}x{w} map")
    if tuple(pos_wu.shape) != (b, 2) or ray_dirs.shape[0] != b or ray_dirs.shape[2] != 2:
        raise ValueError(
            f"shape mismatch: words {tuple(obstacle_words.shape)}, "
            f"pos {tuple(pos_wu.shape)}, dirs {tuple(ray_dirs.shape)}"
        )
    if obstacle_words.dtype != torch.int32:
        raise TypeError(f"obstacle_words must be int32, got {obstacle_words.dtype}")
    if pos_wu.dtype != torch.float32 or ray_dirs.dtype != torch.float32:
        raise TypeError("pos_wu and ray_dirs must be float32")
    devs = {obstacle_words.device, pos_wu.device, ray_dirs.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")


def check_env_tensor(name, x, pos_wu, dtype, tail) -> None:
    """Raise unless ``x`` is a ``dtype`` tensor of shape [B, *tail] on the
    device of ``pos_wu`` [B, 2]."""
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != (pos_wu.shape[0],) + tuple(tail):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{(pos_wu.shape[0],) + tuple(tail)}")
    if x.device != pos_wu.device:
        raise ValueError(f"{name} is on {x.device}, the cast on {pos_wu.device}")


def cast_rays(
    cfg: EnvConfig,
    obstacle_words: torch.Tensor,
    pos_wu: torch.Tensor,
    ray_dirs: torch.Tensor,
) -> RayHits:
    """Batch cast through the backend ``cfg`` resolves for the device the
    tensors live on:

    * ``crossing_kernel`` and ``crossing_kernel_fused``: the crossing cast
      kernel (the fused backend renders pal8 in its own kernel and casts
      through this one for every other observation);
    * ``crossing``: the plain crossing cast (and the two kernel backends in
      a float64 world);
    * ``pallas``: the DDA kernel;
    * ``scan``, ``scan_flat``, ``fused`` and ``analytic``: the plain DDA
      (the fused backend renders camera_u32/rgb/gray in its own kernel and
      casts through the scan for every other observation; the analytic
      backend reaches this function only for families whose maps are not
      border ring + boxes, which cast through the scan as in the JAX
      package).
    """
    backend = cfg.resolved_raycast_backend(pos_wu.device.type)
    if backend in ("crossing_kernel", "crossing_kernel_fused") and cfg.dtype == "float64":
        # the kernel is float32 only; a float64 world casts by the plain
        # crossing, as the JAX package's cast_batch does
        backend = "crossing"
    shape = (cfg.H, cfg.W)
    if backend in ("crossing_kernel", "crossing_kernel_fused"):
        from . import raycast_crossing_kernel as rck

        hit_tu, hit_dim, dist = rck.cast_rays_crossing_kernel(
            obstacle_words, shape, pos_wu, ray_dirs
        )
    elif backend == "crossing":
        hit_tu, hit_dim, dist = cast_rays_crossing(
            obstacle_words, shape, pos_wu, ray_dirs
        )
    elif backend == "pallas":
        from . import raycast_pallas

        hit_tu, hit_dim, dist = raycast_pallas.cast_rays_pallas_batched(
            obstacle_words, shape, pos_wu, ray_dirs, cfg.dda_steps
        )
    elif backend in ("scan", "scan_flat", "fused", "analytic"):
        hit_tu, hit_dim, dist = cast_rays_scan(
            obstacle_words, shape, pos_wu, ray_dirs, cfg.dda_steps,
            early_exit=cfg.dda_early_exit,
        )
    else:
        raise ValueError(f"unknown raycast_backend: {backend}")
    return RayHits(ray_dirs=ray_dirs, hit_tu=hit_tu, hit_dim=hit_dim, dist_wu=dist)
