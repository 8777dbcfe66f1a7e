"""Camera-view renderer -- the RL observation -- batched over envs.

Per ray: fisheye-correct the cast distance by the dot with the player
direction, compute a wall-column height, pick a two-shade slab colour by
(wall, goal or block) x (hit-face axis), and write a mirrored ceiling/wall/floor
column.  The whole ``[B, H_pu, R]`` image is one compare-and-select over a
row index against per-ray pads.  A wall texture (``cfg.wall_texture``)
modulates the wall band per pixel by a brightness factor picked by integer
texel coordinates (:func:`_texture_uv`, :func:`_texture_factor_index`).

``camera_u32`` images are built in int32 (every colour is below 2**24) and
viewed as ``torch.uint32`` only at the public boundary
(:func:`render_observation`), because torch's uint32 lacks the arithmetic.
Divisions by constants divide by a tensor: on CUDA, torch divides by a CPU
scalar through its reciprocal, which is not the IEEE quotient.  The column
geometry runs in the cast's float dtype, with the config's constants
rounded to it (float32, or float64 in a float64 world).

The square root and the heading's cos/sin of a float32 value are the
correctly rounded float32 results (:func:`sqrt_f32`, :func:`cos_f32`,
:func:`sin_f32`): each takes the float64 function of the float32 input and
rounds it, so they are the same on the CPU and on the card.  The JAX package
uses XLA's float32 cos/sin, which differ from the correctly rounded value by
1 ulp on about 1.3% of headings.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import colors, cuda_build
from ..config import EnvConfig
from ..utils import profiling
from . import bitmap
from .raycast import RayHits


def _const(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor of ``value`` on ``like``'s device, of the dtype torch
    infers for it (integer constants)."""
    return torch.tensor(value, device=like.device)


def _fconst(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to ``like``'s float dtype, as a 0-dim tensor on its
    device."""
    return torch.tensor(float(value), dtype=like.dtype, device=like.device)


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
    """(num, denom) of the column height as Python floats, rounded to the
    config's float dtype: ``cam_h * R`` and ``2 * sfov``."""
    return (
        float(cfg.float_dtype(cfg.camera_height_tile_wu * cfg.num_rays)),
        float(cfg.float_dtype(2.0 * cfg.semi_field_of_view_wu)),
    )


def column_pads(player_dir_wu, hits: RayHits, hpu: int, num: float, denom: float):
    """(pad i32[B, R], height_line f[B, R]), the column geometry shared by
    the u32 and pal8 renderers and their fused kernels, in the cast's float
    dtype:
      height_line = num / (denom * projected)
      non-finite height -> full column
      height_pu >= H_pu - 1 -> full wall column (pad 0)
      else pad = (H_pu - height_pu) // 2
    """
    proj = projected_depth(player_dir_wu, hits)
    height_line = _fconst(num, proj) / (_fconst(denom, proj) * proj)
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
    ([B, 1, R] flat, or [B, H_pu, R] textured) between; pads are already in
    column order."""
    row = torch.arange(hpu, dtype=torch.int32, device=pad.device)[None, :, None]
    p = pad[:, None, :]
    return torch.where(
        row < p, ceiling, torch.where(row >= hpu - p, floor, wall_band)
    )


def _row(hpu: int, like: torch.Tensor) -> torch.Tensor:
    """int32[1, H_pu, 1] row index."""
    return torch.arange(hpu, dtype=torch.int32, device=like.device)[None, :, None]


def _texture_uv(cfg: EnvConfig, hits: RayHits, pos_wu, height_line):
    """(ui i32[B, R], vi i32[B, H_pu, R]) integer texel coordinates of the
    wall textures, both in column (mirrored) order; shared by the u32 and
    pal8 renderers, so that their texel selection is the same.

    ``u`` is the fractional hit coordinate along the wall face: the
    cross-axis component of ``pos + dist * dir`` (two roundings) minus the
    hit tile's low edge.  ``v`` runs down the unclipped projected column in
    exact integer arithmetic: with ``h = floor(height_line)`` (at most
    ``cap``, so that ``t * 2 * cap`` stays below 2**31), ``vi = floor(t *
    (2*row - hpu + h) / (2*h))``.  A float ``v`` would sit exactly on 0.5 at
    every column's centre row, where one ulp flips the texel.
    """
    t = cfg.texture_cells
    hpu = cfg.height_camera_view_pu
    dist = hits.dist_wu
    take_j = hits.hit_dim == 0  # an i-face: the cross axis is j
    dir_cross = torch.where(take_j, hits.ray_dirs[..., 1], hits.ray_dirs[..., 0])
    pos_cross = torch.where(take_j, pos_wu[:, 1:2], pos_wu[:, 0:1])
    tile_cross = torch.where(take_j, hits.hit_tu[..., 1], hits.hit_tu[..., 0]).to(dist.dtype)
    cross = pos_cross + dist * dir_cross
    frac_u = torch.clamp(cross - tile_cross, 0.0, 1.0 - 1e-6)
    ui = torch.clamp((frac_u * _fconst(t, frac_u)).to(torch.int32), 0, t - 1)
    ui = torch.flip(ui, dims=(1,))

    cap = min(1 << 20, (1 << 30) // (2 * t))
    hl = torch.flip(height_line, dims=(1,))
    h_full = torch.where(
        torch.isfinite(hl),
        torch.floor(torch.clamp(hl, max=float(cap))).to(torch.int32),
        cap,
    )
    h_full = torch.clamp(h_full, min=1).to(torch.int32)[:, None, :]     # [B, 1, R]
    numer = (2 * _row(hpu, hl) - hpu + h_full) * t                      # [B, H_pu, R]
    vi = torch.clamp(torch.div(numer, 2 * h_full, rounding_mode="floor"), 0, t - 1)
    return ui, vi.to(torch.int32)


def _texture_factor_index(cfg: EnvConfig, ui, vi) -> torch.Tensor:
    """int32[B, H_pu, R] index into ``colors.texture_factors`` of each
    pixel, the texel rule of both renderers.  checker and brick: 0 bright,
    1 dim; xor: the gradient level ``ui ^ vi`` in [0, texture_cells)."""
    t = cfg.texture_cells
    u = ui[:, None, :]
    if cfg.wall_texture == "checker":
        return (u + vi) & 1
    if cfg.wall_texture == "brick":
        course_h = max(t // 4, 1)          # course height in texels
        brick_w = max(t // 2, 2)           # brick length in texels
        off = torch.where(((vi // course_h) & 1) == 1, brick_w // 2, 0)
        mortar = (vi % course_h == 0) | ((u + off) % brick_w == 0)
        return mortar.to(torch.int32)
    return u ^ vi  # "xor"


def _texture_wall(cfg: EnvConfig, slab, hits: RayHits, pos_wu, height_line) -> torch.Tensor:
    """int32[B, H_pu, R] textured wall band: each channel of the slab
    colour (int32[B, R], column order) times the pixel's float32 factor,
    truncated."""
    ui, vi = _texture_uv(cfg, hits, pos_wu, height_line)
    fidx = _texture_factor_index(cfg, ui, vi)
    f32 = lambda v: torch.tensor(np.float32(v), device=fidx.device)  # noqa: E731
    if cfg.wall_texture == "checker":
        factor = torch.where(fidx == 0, f32(1.0), f32(0.55))
    elif cfg.wall_texture == "brick":
        factor = torch.where(fidx == 1, f32(0.45), f32(1.0))
    else:  # "xor": 0.4 + 0.6 * g, rounded twice
        g = fidx.to(torch.float32) / f32(max(cfg.texture_cells - 1, 1))
        factor = f32(0.4) + f32(0.6) * g
    del fidx
    px = slab[:, None, :]
    out = None
    for shift in (16, 8, 0):
        ch = (((px >> shift) & 0xFF).to(torch.float32) * factor).to(torch.int32) << shift
        out = ch if out is None else out | ch
    return out


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


def _check_texture_inputs(cfg: EnvConfig, pos_wu) -> None:
    if cfg.wall_texture != "none" and pos_wu is None:
        raise ValueError("wall_texture requires pos_wu (the ray origin)")


def render_camera_u32(
    cfg: EnvConfig, wall_words, player_dir_wu, hits: RayHits, block_words=None,
    pos_wu=None,
) -> torch.Tensor:
    """int32[B, H_pu, R] 0x00RRGGBB camera views of ``cfg``
    (:func:`camera_u32`); textured walls (``cfg.wall_texture``) need the
    ray origins ``pos_wu`` [B, 2]."""
    _check_texture_inputs(cfg, pos_wu)
    hpu = cfg.height_camera_view_pu
    if cfg.wall_texture == "none":
        return camera_u32(wall_words, (cfg.H, cfg.W), player_dir_wu, hits, hpu,
                          *render_constants(cfg), block_words)
    pad, height_line = column_pads(player_dir_wu, hits, hpu, *render_constants(cfg))
    slab = torch.flip(column_colors_u32(wall_words, (cfg.H, cfg.W), hits, block_words),
                      dims=(1,))
    wall = _texture_wall(cfg, slab, hits, pos_wu, height_line)
    pad = torch.flip(pad, dims=(1,))
    i32 = lambda v: _const(v, pad).to(torch.int32)  # noqa: E731
    return composite(pad, wall, hpu, i32(colors.CEILING), i32(colors.FLOOR))


def u32_to_rgb_plain(img: torch.Tensor) -> torch.Tensor:
    """:func:`u32_to_rgb` in torch ops on any device."""
    img = as_i32(img)
    return torch.stack(
        [(img >> 16) & 0xFF, (img >> 8) & 0xFF, img & 0xFF], dim=-1
    ).to(torch.uint8)


def _uses_kernel(img: torch.Tensor) -> bool:
    """The conversion's dispatch: a CUDA frame goes to the kernel (or
    raises), any other takes the plain version."""
    return img.device.type == "cuda"


def _u32_to_rgb_kernel(img: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's conversion (``csrc/u32_to_rgb.cu``): one launch
    into a fresh contiguous uint8[..., 3], no host read.  A non-contiguous
    frame is made contiguous first; a dtype other than int32 or a uint32
    view raises."""
    img = as_i32(img)
    if img.dtype != torch.int32:
        raise ValueError(f"the RGB conversion takes int32 or uint32 frames, not {img.dtype}")
    img = img.contiguous()
    out = torch.empty(tuple(img.shape) + (3,), dtype=torch.uint8, device=img.device)
    if img.numel() == 0:
        return out
    lib = cuda_build.load()
    cuda_build.launch(lib.rcw_u32_to_rgb, img.device, img.data_ptr(), out.data_ptr(),
                      img.numel(), what="RGB conversion")
    return out


@profiling.span("rcw.ops.u32_to_rgb")
def u32_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """0x00RRGGBB (int32 or uint32 view) -> uint8[..., 3]: R, G, B, the top
    byte ignored.  A CUDA frame launches the kernel once (counted as
    ``kernel_launches.u32_to_rgb``); any other takes
    :func:`u32_to_rgb_plain`."""
    if _uses_kernel(img):
        return _u32_to_rgb_kernel(img)
    return u32_to_rgb_plain(img)


def _luma_sum(img: torch.Tensor) -> torch.Tensor:
    img = as_i32(img)
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


def as_i32(img: torch.Tensor) -> torch.Tensor:
    """uint32 frames as their int32 view (colours are below 2**24, and
    torch's CUDA uint32 support is thin); other tensors as they are."""
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
    cfg: EnvConfig, wall_words, player_dir_wu, hits: RayHits, block_words=None,
    pos_wu=None,
) -> torch.Tensor:
    """uint8[B, H_pu, R] palette-index camera views; lossless:
    ``pal8_to_u32(render_camera_pal8(...), cfg.palette_np) ==
    render_camera_u32(...)``.  A textured wall pixel is
    ``PAL_TEX_BASE + slot * F + factor index`` (the same slots and texel
    rule as the u32 render)."""
    _check_texture_inputs(cfg, pos_wu)
    hpu = cfg.height_camera_view_pu
    pad, height_line = column_pads(player_dir_wu, hits, hpu, *render_constants(cfg))
    if cfg.wall_texture == "none":
        band = torch.flip(column_colors_pal8(wall_words, (cfg.H, cfg.W), hits,
                                             block_words), dims=(1,))[:, None, :]
    else:
        nf = len(colors.texture_factors(cfg.wall_texture, cfg.texture_cells))
        slot = torch.flip(_slab_slots(wall_words, (cfg.H, cfg.W), hits, block_words),
                          dims=(1,))
        ui, vi = _texture_uv(cfg, hits, pos_wu, height_line)
        band = (_texture_factor_index(cfg, ui, vi)
                + (colors.PAL_TEX_BASE + slot * nf)[:, None, :]).to(torch.uint8)
    pad = torch.flip(pad, dims=(1,))
    u8 = lambda v: _const(v, pad).to(torch.uint8)  # noqa: E731
    return composite(pad, band, hpu, u8(colors.PAL_CEILING), u8(colors.PAL_FLOOR))


@profiling.span("rcw.ops.sprite_overlay")
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
    h_line = _fconst(num, proj) / (_fconst(denom, proj) * proj)
    h_line = torch.where(visible & torch.isfinite(h_line), h_line, 0.0)
    h_pu = torch.floor(torch.clamp(h_line, max=float(hpu))).to(torch.int32)
    pad = torch.where(h_pu >= hpu - 1, 0, (hpu - h_pu) // 2)
    bottom = hpu - pad
    sh = _fconst(cfg.float_dtype(sprite_height_wu), h_line)
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


def cos_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded cosine of float32 ``x``: the float64 cosine,
    rounded to float32 (CUDA's float32 ``cosf`` is within 2 ulp, and
    torch's CPU float32 cos is not correctly rounded either)."""
    return torch.cos(x.to(torch.float64)).to(torch.float32)


def sin_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded sine of float32 ``x`` (as :func:`cos_f32`)."""
    return torch.sin(x.to(torch.float64)).to(torch.float32)


def sqrt_of(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root in ``x``'s dtype: :func:`sqrt_f32`
    for float32, torch's own for float64."""
    return sqrt_f32(x) if x.dtype == torch.float32 else torch.sqrt(x)


def ray_circle_t(pos_wu: torch.Tensor, ray_dirs: torch.Tensor, centers: torch.Tensor,
                 center_mask: torch.Tensor, radius_sq) -> torch.Tensor:
    """Nearest positive ray-circle intersection distance f[B, R], +inf
    where every circle is missed.  ``pos_wu`` f[B, 2], ``ray_dirs``
    f[B, R, 2], ``centers`` f[B, K, 2] with bool[B, K] ``center_mask``
    disabling rows, ``radius_sq`` a value of their float dtype.  The
    quadratic b = d.(c-p), disc = b^2 - |c-p|^2 + r^2, near root
    t = b - sqrt(disc), every product and sum rounded on its own."""
    dx = ray_dirs[..., 0, None]                                 # [B, R, 1]
    dy = ray_dirs[..., 1, None]
    ox = (centers[..., 0] - pos_wu[:, 0:1])[:, None, :]         # [B, 1, K]
    oy = (centers[..., 1] - pos_wu[:, 1:2])[:, None, :]
    b = dx * ox + dy * oy                                       # [B, R, K]
    c2 = ox * ox + oy * oy
    disc = b * b - c2 + _fconst(radius_sq, b)
    t = b - sqrt_of(torch.clamp(disc, min=0.0))
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
    """Decode palette indices to 0x00RRGGBB, returned as a uint32 view;
    ``palette`` defaults to the 12-entry base palette, textured configs pass
    ``cfg.palette_np``."""
    pal = np.asarray(colors.PALETTE_NP if palette is None else palette, np.uint32)
    table = torch.from_numpy(pal.view(np.int32)).to(img.device)
    return table[img.to(torch.int64)].view(torch.uint32)


@profiling.span("rcw.ops.render_observation")
def render_observation(
    cfg: EnvConfig, wall_words, goal_tu, player_dir_wu, hits: RayHits,
    block_words=None, goal_words=None, pos_wu=None,
) -> torch.Tensor:
    """Dispatch on ``cfg.obs_type``; the result has the observation space's
    dtype (``camera_u32`` as a uint32 view).  ``block_words`` (packed block
    tiles, or None) render in the block shades; ``goal_words`` (packed goal
    tiles, or None for the single ``goal_tu``) mark the tile grid's goals;
    ``pos_wu`` (the ray origins) textures the walls.  ``tile_grid`` reads
    no cast: ``player_dir_wu`` and ``hits`` may be None."""
    if cfg.obs_type == "tile_grid":
        return tile_grid(cfg, wall_words, goal_tu, block_words, goal_words)
    if cfg.obs_type in ("top_u32", "top_rgb"):
        raise ValueError("top views are drawn by ops/topview.py (Game.top_view_batch), "
                         "not from camera hits")
    if cfg.obs_type == "depth":
        return torch.flip(projected_depth(player_dir_wu, hits), dims=(1,))
    if cfg.obs_type == "camera_pal8":
        return render_camera_pal8(cfg, wall_words, player_dir_wu, hits, block_words,
                                  pos_wu)
    img = render_camera_u32(cfg, wall_words, player_dir_wu, hits, block_words, pos_wu)
    if cfg.obs_type == "camera_u32":
        return img.view(torch.uint32)
    if cfg.obs_type == "camera_rgb":
        return u32_to_rgb(img)
    if cfg.obs_type == "camera_gray":
        return u32_to_gray(img)
    if cfg.obs_type == "camera_gray_u8":
        return u32_to_gray_u8(img)
    raise AssertionError(cfg.obs_type)
