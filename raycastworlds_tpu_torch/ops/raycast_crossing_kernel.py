"""The crossing cast as hand-written CUDA kernels.

The port of the JAX package's Pallas kernels of the same module name:

* :func:`cast_rays_crossing_kernel` (``csrc/crossing_cast.cu``), the batch
  crossing cast;
* :func:`cast_render_pal8_kernel` (``csrc/crossing_render_pal8.cu``), the
  same cast on a mirror-ordered fan fused with the pal8 camera render
  (backend ``crossing_kernel_fused``).

For a CUDA tensor each wrapper launches its kernel (through
``cuda_build.launch``, which counts it); for a CPU tensor it runs
the kernel's plain PyTorch version (``*_ref``), which the tests hold against
the JAX package and ``chip_smoke.py`` holds the kernel against on the card.
There is no fallback: any other device, a dtype or shape the kernel does
not take, or a failed launch raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import colors, cuda_build
from . import bitmap, raycast, render

_BIG = float(np.finfo(np.float32).max)


def _axis_loop_ref(
    words, w, d_main, d_cross, p_main, p_cross, n, size_cross, main_is_i
):
    """One axis of the kernel, as the kernel computes it: a loop over the
    n candidates with a running (t, k, cross tile) min in ``[B, R]``
    tensors, strict ``<`` in ascending k, and a direct bit test of the
    entered tile."""
    fl = torch.floor(p_main)
    main0 = fl.to(torch.int32)                                   # [B, 1]
    neg = d_main < 0
    step = torch.where(neg, -1, 1).to(torch.int32)
    frac = p_main - fl
    frac_sel = torch.where(neg, frac, 1.0 - frac)
    ad = torch.abs(d_main)
    best = torch.full_like(d_main, _BIG)
    kb = torch.zeros_like(step)
    cb = torch.zeros_like(step)
    for k in range(n):
        t = (frac_sel + float(k)) / ad
        finite = torch.isfinite(t)
        c = torch.where(finite, p_cross + t * d_cross, 0.0)
        if main_is_i:
            c_tile = torch.where(d_cross >= 0, torch.floor(c), torch.ceil(c) - 1.0)
        else:
            c_tile = torch.where(d_cross > 0, torch.ceil(c) - 1.0, torch.floor(c))
        c_idx = torch.clamp(c_tile, 0.0, float(size_cross - 1)).to(torch.int32)
        m = torch.clamp(main0 + (k + 1) * step, 0, n - 1)
        bit = m * w + c_idx if main_is_i else c_idx * w + m
        occ = bitmap.lookup_bit(words, bit) & finite
        t_m = torch.where(occ, t, _BIG)
        better = t_m < best
        best = torch.where(better, t_m, best)
        kb = torch.where(better, k, kb)
        cb = torch.where(better, c_idx, cb)
    return best, main0 + (kb + 1) * step, cb


def cast_rays_crossing_kernel_ref(
    obstacle_words: torch.Tensor,
    shape: Tuple[int, int],
    pos_wu: torch.Tensor,
    ray_dirs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: same contract, same arithmetic."""
    h, w = shape
    dx = ray_dirs[..., 0]
    dy = ray_dirs[..., 1]
    px = pos_wu[:, 0:1]
    py = pos_wu[:, 1:2]
    ti, ii, ji = _axis_loop_ref(obstacle_words, w, dx, dy, px, py, h, w, True)
    tj, jj, ij = _axis_loop_ref(obstacle_words, w, dy, dx, py, px, w, h, False)
    use_j = tj <= ti  # ties check j first, like the sequential march
    dist = torch.where(use_j, tj, ti)
    hit_i = torch.where(use_j, ij, ii)
    hit_j = torch.where(use_j, jj, ji)
    return torch.stack([hit_i, hit_j], dim=-1), use_j.to(torch.int32), dist


def cast_rays_crossing_kernel(
    obstacle_words: torch.Tensor,   # i32[B, NW] packed obstacle words
    shape: Tuple[int, int],
    pos_wu: torch.Tensor,           # f32[B, 2]
    ray_dirs: torch.Tensor,         # f32[B, R, 2]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch crossing cast.  Returns (hit_tu i32[B, R, 2], hit_dim i32[B, R],
    dist f32[B, R]).  Any B >= 1 and any R; raises where the map's words
    exceed what the kernel's shared memory holds.
    """
    raycast.check_cast_inputs(obstacle_words, shape, pos_wu, ray_dirs)
    dev = pos_wu.device
    if dev.type == "cpu":
        return cast_rays_crossing_kernel_ref(obstacle_words, shape, pos_wu, ray_dirs)
    lib = cuda_build.kernel_library(
        dev, obstacle_words.shape[1], ray_dirs.shape[0], ray_dirs.shape[1],
        "crossing cast", obstacle_words=obstacle_words, pos_wu=pos_wu,
        ray_dirs=ray_dirs,
    )
    h, w = shape
    b, r = ray_dirs.shape[0], ray_dirs.shape[1]
    hit_tu = torch.empty((b, r, 2), dtype=torch.int32, device=dev)
    hit_dim = torch.empty((b, r), dtype=torch.int32, device=dev)
    dist = torch.empty((b, r), dtype=torch.float32, device=dev)
    cuda_build.launch(
        lib.rcw_crossing_cast, dev,
        obstacle_words.data_ptr(), pos_wu.data_ptr(), ray_dirs.data_ptr(),
        hit_tu.data_ptr(), hit_dim.data_ptr(), dist.data_ptr(),
        b, r, h, w, obstacle_words.shape[1], what="crossing cast",
    )
    return hit_tu, hit_dim, dist


def cast_render_pal8_kernel_ref(
    obstacle_words: torch.Tensor,
    shape: Tuple[int, int],
    pos_wu: torch.Tensor,
    ray_dirs_flipped: torch.Tensor,
    player_dir: torch.Tensor,
    goal_tu: torch.Tensor,
    hpu: int,
    num: float,
    denom: float,
) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: the crossing kernel's cast
    on the mirror-ordered fan, then the column geometry of the plain render
    and a slab that is goal-vs-wall by equality of the hit tile with the
    goal tile.  Columns come out in fan order (already mirrored)."""
    hit_tu, hit_dim, dist = cast_rays_crossing_kernel_ref(
        obstacle_words, shape, pos_wu, ray_dirs_flipped
    )
    hits = raycast.RayHits(ray_dirs=ray_dirs_flipped, hit_tu=hit_tu,
                           hit_dim=hit_dim, dist_wu=dist)
    pad, _ = render.column_pads(player_dir, hits, hpu, num, denom)
    dim_i = hit_dim == 0
    is_goal = (hit_tu[..., 0] == goal_tu[:, 0:1]) & (hit_tu[..., 1] == goal_tu[:, 1:2])
    u8 = lambda v: torch.tensor(v, dtype=torch.uint8, device=pad.device)  # noqa: E731
    slab = torch.where(
        is_goal,
        torch.where(dim_i, u8(colors.PAL_GOAL_DIM_I), u8(colors.PAL_GOAL_DIM_J)),
        torch.where(dim_i, u8(colors.PAL_WALL_DIM_I), u8(colors.PAL_WALL_DIM_J)),
    )
    return render.composite(pad, slab[:, None, :], hpu,
                            u8(colors.PAL_CEILING), u8(colors.PAL_FLOOR))


def cast_render_pal8_kernel(
    obstacle_words: torch.Tensor,    # i32[B, NW] packed obstacle words
    shape: Tuple[int, int],
    pos_wu: torch.Tensor,            # f32[B, 2]
    ray_dirs_flipped: torch.Tensor,  # f32[B, R, 2] mirror-ordered fan
    player_dir: torch.Tensor,        # f32[B, 2]
    goal_tu: torch.Tensor,           # i32[B, 2] the single goal tile
    hpu: int,
    num: float,
    denom: float,
) -> torch.Tensor:
    """uint8[B, hpu, R] pal8 camera views, cast and render in one kernel.
    ``num`` and ``denom`` are the float32 render constants
    (:func:`render.render_constants`).  Valid where the obstacle map is the
    walls plus the goal tile, which lies on an empty tile.
    """
    raycast.check_cast_inputs(obstacle_words, shape, pos_wu, ray_dirs_flipped)
    raycast.check_env_tensor("player_dir", player_dir, pos_wu, torch.float32, (2,))
    raycast.check_env_tensor("goal_tu", goal_tu, pos_wu, torch.int32, (2,))
    if hpu < 1:
        raise ValueError(f"hpu must be >= 1, got {hpu}")
    dev = pos_wu.device
    if dev.type == "cpu":
        return cast_render_pal8_kernel_ref(
            obstacle_words, shape, pos_wu, ray_dirs_flipped, player_dir,
            goal_tu, hpu, num, denom,
        )
    b, r = ray_dirs_flipped.shape[0], ray_dirs_flipped.shape[1]
    nw = obstacle_words.shape[1]
    lib = cuda_build.kernel_library(
        dev, nw, b, r, "crossing cast + pal8 render",
        obstacle_words=obstacle_words, pos_wu=pos_wu,
        ray_dirs_flipped=ray_dirs_flipped, player_dir=player_dir,
        goal_tu=goal_tu,
    )
    h, w = shape
    img = torch.empty((b, hpu, r), dtype=torch.uint8, device=dev)
    cuda_build.launch(
        lib.rcw_crossing_render_pal8, dev,
        obstacle_words.data_ptr(), pos_wu.data_ptr(),
        ray_dirs_flipped.data_ptr(), player_dir.data_ptr(),
        goal_tu.data_ptr(), img.data_ptr(), b, r, h, w, nw, hpu, num, denom,
        what="crossing cast + pal8 render",
    )
    return img
