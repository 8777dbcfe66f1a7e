"""Camera-view renderer -- the RL observation -- batched over envs.

Per ray: fisheye-correct the cast distance by the dot with the player
direction, compute a wall-column height, pick a two-shade slab colour by
(wall, goal or block) x (hit-face axis), and write a mirrored ceiling/wall/floor
column.  The whole ``[B, H_pu, R]`` image is one compare-and-select over a
row index against per-ray pads.

``camera_u32`` images are built in int32 (every colour is below 2**24) and
viewed as ``torch.uint32`` only at the public boundary
(:func:`render_observation`), because torch's uint32 lacks the arithmetic.
Divisions by constants divide by a tensor: on CUDA, torch divides by a CPU
scalar through its reciprocal, which is not the IEEE quotient.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import colors
from ..config import EnvConfig
from . import bitmap
from .raycast import RayHits

_NOT_PORTED = {
    "textures": "ROADMAP Queue 1 item 15",
}


def _not_ported(what: str):
    return NotImplementedError(f"{what} not ported yet ({_NOT_PORTED[what]})")


def _const(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor on ``like``'s device (float32 constants go through
    np.float32 so both packages embed the same bits)."""
    return torch.tensor(value, device=like.device)


def projected_depth(player_dir_wu: torch.Tensor, hits: RayHits) -> torch.Tensor:
    """Fisheye-corrected depth ``dist * dot(player_dir, ray_dir)``: f32[B, R]."""
    rd = hits.ray_dirs
    dot = player_dir_wu[:, 0:1] * rd[..., 0] + player_dir_wu[:, 1:2] * rd[..., 1]
    return hits.dist_wu * dot


def _hit_tile_bit(shape, hits: RayHits) -> torch.Tensor:
    """Bit index i32[B, R] of each hit tile, clamped into the map."""
    h, w = shape
    hi = torch.clamp(hits.hit_tu[..., 0], 0, h - 1)
    hj = torch.clamp(hits.hit_tu[..., 1], 0, w - 1)
    return hi * w + hj


def _slab_slots(wall_words, shape, hits: RayHits, block_words=None) -> torch.Tensor:
    """Per-ray slab slot i32[B, R] in ``colors.TEX_SLABS`` order (wall_i,
    wall_j, goal_i, goal_j, block_i, block_j): wall where the hit tile has
    the wall bit, else block where ``block_words`` (packed block tiles, or
    None) has it, else goal; shade by hit-face axis."""
    bit = _hit_tile_bit(shape, hits)
    is_wall = bitmap.lookup_bit(wall_words, bit)
    dim_j = (hits.hit_dim == 1).to(torch.int32)
    slot = torch.where(is_wall, dim_j, 2 + dim_j)
    if block_words is not None:
        is_block = bitmap.lookup_bit(block_words, bit)
        slot = torch.where(is_block & ~is_wall, 4 + dim_j, slot)
    return slot


def column_colors_u32(wall_words, shape, hits: RayHits,
                      block_words=None) -> torch.Tensor:
    """Per-ray slab colour, int32[B, R] 0x00RRGGBB, of each slab slot."""
    table = torch.tensor(colors.TEX_SLABS, dtype=torch.int32, device=hits.hit_dim.device)
    return table[_slab_slots(wall_words, shape, hits, block_words)]


def render_constants(cfg: EnvConfig):
    """(num, denom) of the column height, float32 values as Python floats:
    ``cam_h * R`` and ``2 * sfov``."""
    return (
        float(np.float32(cfg.camera_height_tile_wu * cfg.num_rays)),
        float(np.float32(2.0 * cfg.semi_field_of_view_wu)),
    )


def column_pads(player_dir_wu, hits: RayHits, hpu: int, num: float, denom: float):
    """(pad i32[B, R], height_line f32[B, R]), the column geometry shared by
    the u32 and pal8 renderers and their fused kernels:
      height_line = num / (denom * projected)
      non-finite height -> full column
      height_pu >= H_pu - 1 -> full wall column (pad 0)
      else pad = (H_pu - height_pu) // 2
    """
    proj = projected_depth(player_dir_wu, hits)
    num_c = _const(np.float32(num), proj)
    denom_c = _const(np.float32(denom), proj)
    height_line = num_c / (denom_c * proj)
    finite = torch.isfinite(height_line)
    # Clamp before the int cast; clamping at hpu keeps `>= hpu - 1` intact.
    h_pu = torch.where(
        finite,
        torch.floor(torch.clamp(height_line, max=float(hpu))).to(torch.int32),
        hpu,
    )
    pad = torch.where(h_pu >= hpu - 1, 0, (hpu - h_pu) // 2).to(torch.int32)
    return pad, height_line


def composite(pad: torch.Tensor, wall_band: torch.Tensor, hpu: int,
              ceiling: torch.Tensor, floor: torch.Tensor) -> torch.Tensor:
    """[B, H_pu, R] image: ceiling above the pad, floor below, wall band
    ([B, 1, R]) between; pads are already in column order."""
    row = torch.arange(hpu, dtype=torch.int32, device=pad.device)[None, :, None]
    p = pad[:, None, :]
    return torch.where(
        row < p, ceiling, torch.where(row >= hpu - p, floor, wall_band)
    )


def camera_u32(wall_words, shape, player_dir_wu, hits: RayHits, hpu: int,
               num: float, denom: float, block_words=None) -> torch.Tensor:
    """int32[B, hpu, R] flat-shaded 0x00RRGGBB camera views; columns are
    written mirrored (column ``R - 1 - i`` shows ray ``i``)."""
    pad, _ = column_pads(player_dir_wu, hits, hpu, num, denom)
    slab = column_colors_u32(wall_words, shape, hits, block_words)
    # Mirror the per-ray vectors before the [H_pu, R] broadcast.
    pad = torch.flip(pad, dims=(1,))
    slab = torch.flip(slab, dims=(1,))
    i32 = lambda v: _const(v, pad).to(torch.int32)  # noqa: E731
    return composite(pad, slab[:, None, :], hpu, i32(colors.CEILING),
                     i32(colors.FLOOR))


def render_camera_u32(
    cfg: EnvConfig, wall_words, player_dir_wu, hits: RayHits, block_words=None
) -> torch.Tensor:
    """int32[B, H_pu, R] 0x00RRGGBB camera views of ``cfg``
    (:func:`camera_u32`)."""
    if cfg.wall_texture != "none":
        raise _not_ported("textures")
    return camera_u32(wall_words, (cfg.H, cfg.W), player_dir_wu, hits,
                      cfg.height_camera_view_pu, *render_constants(cfg),
                      block_words)


def u32_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """0x00RRGGBB (int32 or uint32 view) -> uint8[..., 3]."""
    img = _as_i32(img)
    return torch.stack(
        [(img >> 16) & 0xFF, (img >> 8) & 0xFF, img & 0xFF], dim=-1
    ).to(torch.uint8)


def _luma_sum(img: torch.Tensor) -> torch.Tensor:
    img = _as_i32(img)
    r = ((img >> 16) & 0xFF).to(torch.float32)
    g = ((img >> 8) & 0xFF).to(torch.float32)
    b = (img & 0xFF).to(torch.float32)
    return 0.299 * r + 0.587 * g + 0.114 * b


def u32_to_gray(img: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma in [0, 1], float32."""
    s = _luma_sum(img)
    return s / _const(np.float32(255.0), s)


def u32_to_gray_u8(img: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma rounded to uint8 (+0.5 then truncate)."""
    return (_luma_sum(img) + 0.5).to(torch.uint8)


def _as_i32(img: torch.Tensor) -> torch.Tensor:
    return img.view(torch.int32) if img.dtype == torch.uint32 else img


_PAL_SLABS = (colors.PAL_WALL_DIM_I, colors.PAL_WALL_DIM_J, colors.PAL_GOAL_DIM_I,
              colors.PAL_GOAL_DIM_J, colors.PAL_BLOCK_DIM_I, colors.PAL_BLOCK_DIM_J)


def column_colors_pal8(wall_words, shape, hits: RayHits,
                       block_words=None) -> torch.Tensor:
    """Per-ray slab palette index, uint8[B, R] -- the 1-byte twin of
    :func:`column_colors_u32` (same slots)."""
    table = torch.tensor(_PAL_SLABS, dtype=torch.uint8, device=hits.hit_dim.device)
    return table[_slab_slots(wall_words, shape, hits, block_words)]


def render_camera_pal8(
    cfg: EnvConfig, wall_words, player_dir_wu, hits: RayHits, block_words=None
) -> torch.Tensor:
    """uint8[B, H_pu, R] palette-index camera views; lossless:
    ``pal8_to_u32(render_camera_pal8(...)) == render_camera_u32(...)``."""
    if cfg.wall_texture != "none":
        raise _not_ported("textures")
    pad, _ = column_pads(player_dir_wu, hits, cfg.height_camera_view_pu,
                         *render_constants(cfg))
    slab = column_colors_pal8(wall_words, (cfg.H, cfg.W), hits, block_words)
    pad = torch.flip(pad, dims=(1,))
    slab = torch.flip(slab, dims=(1,))
    u8 = lambda v: _const(v, pad).to(torch.uint8)  # noqa: E731
    return composite(
        pad, slab[:, None, :], cfg.height_camera_view_pu,
        u8(colors.PAL_CEILING), u8(colors.PAL_FLOOR),
    )


def sprite_overlay(cfg: EnvConfig, img: torch.Tensor, player_dir_wu, hits: RayHits,
                   t_sprite: torch.Tensor, color: int, sprite_height_wu: float
                   ) -> torch.Tensor:
    """Floor-standing billboard sprite columns over camera images
    ``img`` [B, H_pu, R] (int32 u32 colours or uint8 palette indices).

    ``t_sprite`` f32[B, R] is the distance along each (cast-order) ray to
    the nearest sprite, +inf where it misses.  A sprite shows where it is
    closer than the wall hit, as a column whose bottom is where a wall
    column at its fisheye-projected distance ends (the pad rule of
    :func:`column_pads`) and whose height is ``sprite_height_wu`` of that
    wall height, in ``color`` (of the image's dtype)."""
    hpu = cfg.height_camera_view_pu
    num, denom = render_constants(cfg)
    visible = t_sprite < hits.dist_wu
    proj = projected_depth(player_dir_wu, hits._replace(dist_wu=t_sprite))
    h_line = _const(np.float32(num), proj) / (_const(np.float32(denom), proj) * proj)
    h_line = torch.where(visible & torch.isfinite(h_line), h_line, 0.0)
    h_pu = torch.floor(torch.clamp(h_line, max=float(hpu))).to(torch.int32)
    pad = torch.where(h_pu >= hpu - 1, 0, (hpu - h_pu) // 2)
    bottom = hpu - pad
    sh = _const(np.float32(sprite_height_wu), h_line)
    hs = torch.floor(torch.clamp(sh * h_line, max=float(hpu))).to(torch.int32)
    top = torch.clamp(bottom - hs, min=0)
    # Mirror the per-ray vectors before the [H_pu, R] broadcast.
    visible, top, bottom = (torch.flip(v, dims=(1,))[:, None, :]
                            for v in (visible, top, bottom))
    row = torch.arange(hpu, dtype=torch.int32, device=img.device)[None, :, None]
    mask = visible & (row >= top) & (row < bottom)
    return torch.where(mask, _const(color, img).to(img.dtype), img)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of float32 ``x``.  torch's CPU
    float32 sqrt is not (its vectorized kernel is an ulp off on about 0.5%
    of inputs); the float64 root of a float32 value, rounded to float32, is,
    even where that float64 root is an ulp off."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def ray_circle_t(pos_wu: torch.Tensor, ray_dirs: torch.Tensor, centers: torch.Tensor,
                 center_mask: torch.Tensor, radius_sq) -> torch.Tensor:
    """Nearest positive ray-circle intersection distance f32[B, R], +inf
    where every circle is missed.  ``pos_wu`` f32[B, 2], ``ray_dirs``
    f32[B, R, 2], ``centers`` f32[B, K, 2] with bool[B, K] ``center_mask``
    disabling rows, ``radius_sq`` a float32 value.  The quadratic
    b = d.(c-p), disc = b^2 - |c-p|^2 + r^2, near root t = b - sqrt(disc),
    every product and sum rounded on its own."""
    dx = ray_dirs[..., 0, None]                                 # [B, R, 1]
    dy = ray_dirs[..., 1, None]
    ox = (centers[..., 0] - pos_wu[:, 0:1])[:, None, :]         # [B, 1, K]
    oy = (centers[..., 1] - pos_wu[:, 1:2])[:, None, :]
    b = dx * ox + dy * oy                                       # [B, R, K]
    c2 = ox * ox + oy * oy
    disc = b * b - c2 + _const(np.float32(radius_sq), b)
    t = b - sqrt_f32(torch.clamp(disc, min=0.0))
    valid = center_mask[:, None, :] & (disc >= 0) & (t > 0)
    return torch.where(valid, t, float("inf")).amin(dim=-1)


def tile_grid(cfg: EnvConfig, wall_words, goal_tu, block_words=None,
              goal_words=None) -> torch.Tensor:
    """int32[B, H, W] tile map: walls 1, then blocks 3, then the goal words
    (or else the goal tile) 2, each over the ones before."""
    shape = (cfg.H, cfg.W)
    grid = bitmap.unpack_bits(wall_words, shape).to(torch.int32)
    if block_words is not None:
        grid = torch.where(bitmap.unpack_bits(block_words, shape), 3, grid)
    goal = (goal_tile_map(goal_tu, shape) if goal_words is None
            else bitmap.unpack_bits(goal_words, shape))
    return torch.where(goal, 2, grid).to(torch.int32)


def goal_tile_map(goal_tu: torch.Tensor, shape) -> torch.Tensor:
    """bool[B, H, W], true at each env's goal tile ``goal_tu`` (int32[B, 2]):
    an index compare, no scatter."""
    h, w = shape
    ii = torch.arange(h, device=goal_tu.device)[None, :, None]
    jj = torch.arange(w, device=goal_tu.device)[None, None, :]
    return (ii == goal_tu[:, 0, None, None]) & (jj == goal_tu[:, 1, None, None])


def pal8_to_u32(img: torch.Tensor, palette=None) -> torch.Tensor:
    """Decode palette indices to 0x00RRGGBB, returned as a uint32 view."""
    pal = np.asarray(colors.PALETTE_NP if palette is None else palette, np.uint32)
    table = torch.from_numpy(pal.view(np.int32)).to(img.device)
    return table[img.to(torch.int64)].view(torch.uint32)


def render_observation(
    cfg: EnvConfig, wall_words, goal_tu, player_dir_wu, hits: RayHits,
    block_words=None, goal_words=None,
) -> torch.Tensor:
    """Dispatch on ``cfg.obs_type``; the result has the observation space's
    dtype (``camera_u32`` as a uint32 view).  ``block_words`` (packed block
    tiles, or None) render in the block shades; ``goal_words`` (packed goal
    tiles, or None for the single ``goal_tu``) mark the tile grid's goals.
    ``tile_grid`` reads no cast: ``player_dir_wu`` and ``hits`` may be None."""
    if cfg.obs_type == "tile_grid":
        return tile_grid(cfg, wall_words, goal_tu, block_words, goal_words)
    if cfg.obs_type in ("top_u32", "top_rgb"):
        raise ValueError("top views are drawn by ops/topview.py (Game.top_view_batch), "
                         "not from camera hits")
    if cfg.obs_type == "depth":
        return torch.flip(projected_depth(player_dir_wu, hits), dims=(1,))
    if cfg.obs_type == "camera_pal8":
        return render_camera_pal8(cfg, wall_words, player_dir_wu, hits, block_words)
    img = render_camera_u32(cfg, wall_words, player_dir_wu, hits, block_words)
    if cfg.obs_type == "camera_u32":
        return img.view(torch.uint32)
    if cfg.obs_type == "camera_rgb":
        return u32_to_rgb(img)
    if cfg.obs_type == "camera_gray":
        return u32_to_gray(img)
    if cfg.obs_type == "camera_gray_u8":
        return u32_to_gray_u8(img)
    raise AssertionError(cfg.obs_type)
