"""Render palette: the JAX package's ``colors`` constants, copied so the port
does not import the JAX package.  Values are 0x00RRGGBB."""

from __future__ import annotations

import numpy as np

TILE_WALL = 0x00FFFFFF
TILE_GOAL = 0x00FF0000
TILE_EMPTY = 0x00000000

RAY = 0x00808080
PLAYER = 0x00C0C0C0
FLOOR = 0x00404040
CEILING = 0x00FFFFFF
WALL_DIM_I = 0x00808080   # hit face perpendicular to the i-axis
WALL_DIM_J = 0x00C0C0C0   # hit face perpendicular to the j-axis
GOAL_DIM_I = 0x00800000
GOAL_DIM_J = 0x00C00000
GRID_LINE = 0x00CCCCCC

TILE_BLOCK = 0x000000FF
BLOCK_DIM_I = 0x00000080
BLOCK_DIM_J = 0x000000C0

# Canonical palette of the 1-byte "camera_pal8" observation.  Index order is
# frozen: parity tests and trained policies depend on it.
PALETTE = (
    0x00000000,  # 0  black (empty tile)
    0x00FFFFFF,  # 1  white (ceiling, tile-map wall)
    0x00808080,  # 2  gray (wall face dim-i, top-view rays)
    0x00C0C0C0,  # 3  light gray (wall face dim-j, player)
    0x00404040,  # 4  dark gray (floor)
    0x00FF0000,  # 5  red (tile-map goal)
    0x00800000,  # 6  dark red (goal face dim-i)
    0x00C00000,  # 7  mid red (goal face dim-j)
    0x00CCCCCC,  # 8  grid-line gray
    0x000000FF,  # 9  blue (tile-map block)
    0x00000080,  # 10 dark blue (block face dim-i)
    0x000000C0,  # 11 mid blue (block face dim-j)
)

PAL_EMPTY = 0
PAL_CEILING = 1
PAL_WALL_DIM_I = 2
PAL_WALL_DIM_J = 3
PAL_FLOOR = 4
PAL_GOAL = 5
PAL_GOAL_DIM_I = 6
PAL_GOAL_DIM_J = 7
PAL_GRID_LINE = 8
PAL_BLOCK = 9
PAL_BLOCK_DIM_I = 10
PAL_BLOCK_DIM_J = 11

PALETTE_NP = np.array(PALETTE, dtype=np.uint32)

# Textured pal8 palettes append 6 slab colors x at most this many factors.
PAL_TEX_BASE = 12
TEX_SLABS = (
    WALL_DIM_I, WALL_DIM_J, GOAL_DIM_I, GOAL_DIM_J, BLOCK_DIM_I, BLOCK_DIM_J
)
MAX_TEX_FACTORS = (256 - PAL_TEX_BASE) // len(TEX_SLABS)  # 40


def texture_factors(wall_texture: str, texture_cells: int) -> np.ndarray:
    """float32[F] brightness factors of a texture, in the factor-index order
    the renderers compute per pixel: checker {1, 0.55}, brick {1, 0.45},
    xor ``0.4 + 0.6 * k / (t - 1)`` for k in [0, t), each product and sum
    rounded to float32 on its own, as ``ops/render.py`` computes them."""
    if wall_texture == "checker":
        return np.array([1.0, 0.55], np.float32)
    if wall_texture == "brick":
        return np.array([1.0, 0.45], np.float32)
    if wall_texture == "xor":
        t = texture_cells
        g = np.arange(t, dtype=np.float32) / np.float32(max(t - 1, 1))
        return (np.float32(0.4) + np.float32(0.6) * g).astype(np.float32)
    raise ValueError(f"no texture factors for wall_texture={wall_texture!r}")


def build_texture_palette(wall_texture: str, texture_cells: int) -> np.ndarray:
    """uint32[12 + 6*F] palette of a textured config: ``PALETTE``, then each
    ``TEX_SLABS`` colour under each factor (entry ``12 + slot*F + factor``),
    every channel multiplied by the float32 factor and truncated, as the u32
    renderer does, so decoding a textured pal8 frame gives its u32 frame."""
    fac = texture_factors(wall_texture, texture_cells)
    if len(fac) > MAX_TEX_FACTORS:
        raise ValueError(
            f"{wall_texture} with texture_cells={texture_cells} needs "
            f"{len(fac)} factors; pal8 fits at most {MAX_TEX_FACTORS}"
        )
    slabs = np.array(TEX_SLABS, np.uint32)
    chans = np.stack([(slabs >> 16) & 0xFF, (slabs >> 8) & 0xFF, slabs & 0xFF],
                     axis=-1).astype(np.float32)                   # [6, 3]
    scaled = (chans[:, None, :] * fac[None, :, None]).astype(np.uint32)  # [6, F, 3]
    tex = (scaled[..., 0] << 16) | (scaled[..., 1] << 8) | scaled[..., 2]
    return np.concatenate([PALETTE_NP, tex.reshape(-1)]).astype(np.uint32)


def palette_rgb_f32(palette_np: np.ndarray) -> np.ndarray:
    """[N, 3] float32 RGB in [0, 1] decode table of a palette."""
    p = np.asarray(palette_np, dtype=np.uint32)
    return (
        np.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], axis=-1)
        .astype(np.float32)
        / np.float32(255.0)
    )


# [12, 3] float32 RGB in [0, 1] of the base palette (the learner's decode
# table of camera_pal8 without textures).
PALETTE_RGB_F32 = palette_rgb_f32(PALETTE_NP)


def pal8_to_u32_np(img_pal8: np.ndarray, palette: np.ndarray = None) -> np.ndarray:
    """Decode a palette-index image to 0x00RRGGBB uint32 (host side);
    textured configs pass ``cfg.palette_np``."""
    pal = PALETTE_NP if palette is None else np.asarray(palette, np.uint32)
    return pal[np.asarray(img_pal8, dtype=np.int64)]


def u32_to_rgb(img_u32: np.ndarray) -> np.ndarray:
    """Unpack a 0x00RRGGBB uint32 image to uint8 [..., 3] RGB (host side)."""
    img_u32 = np.asarray(img_u32, dtype=np.uint32)
    r = (img_u32 >> 16) & 0xFF
    g = (img_u32 >> 8) & 0xFF
    b = img_u32 & 0xFF
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def rgb_to_u32(rgb: np.ndarray) -> np.ndarray:
    """Pack uint8-valued [..., 3] RGB into 0x00RRGGBB uint32 (host side),
    the inverse of :func:`u32_to_rgb`."""
    rgb = np.asarray(rgb, dtype=np.uint32)
    return (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
