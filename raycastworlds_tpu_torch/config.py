"""Static environment configuration (PyTorch port of ``raycastworlds_tpu.config``).

``EnvConfig`` mirrors the JAX package's config field for field, with the same
validation, so one set of keyword arguments describes a world in both
packages.  The host-side lookup tables are computed the same way, in float64
NumPy cast once, so both packages embed bit-identical constants.

0-indexed throughout: tile ``(i, j)`` occupies world units
``[i, i+1) x [j, j+1)``; ``wu_to_tu(x) = floor(x)``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np

# Object channels of the tile map (``state.tile_map``'s channel axis).
NUM_OBJECTS = 2
WALL = 0
GOAL = 1

# Discrete action set.
NUM_ACTIONS = 4
MOVE_FORWARD = 0
MOVE_BACKWARD = 1
TURN_LEFT = 2
TURN_RIGHT = 3

ACTION_NAMES = ("MOVE_FORWARD", "MOVE_BACKWARD", "TURN_LEFT", "TURN_RIGHT")

# Hit-face axis of a cast (``RayHits.hit_dim``): 0 = the face perpendicular
# to the i axis, 1 = perpendicular to the j axis.
HIT_DIM_I = 0
HIT_DIM_J = 1

OBS_TYPES = (
    "camera_u32", "camera_rgb", "camera_gray", "camera_pal8",
    "camera_gray_u8", "depth", "tile_grid", "top_u32", "top_rgb",
)
RAYCAST_BACKENDS = (
    "scan", "scan_flat", "crossing", "crossing_kernel",
    "crossing_kernel_fused", "analytic", "pallas", "fused", "auto",
)

# The most packed words per env that the CUDA kernels hold in a block's
# shared memory: kSmemWords of csrc/crossing_cast.cu (48 KiB of uint32).
# ``auto`` keeps larger maps off the kernels without building them.
KERNEL_MAX_WORDS = 48 * 1024 // 4


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """The JAX package's ``EnvConfig``, field for field (see its docstrings
    for each field's meaning)."""

    height_tile_map_tu: int = 8
    width_tile_map_tu: int = 16
    num_directions: int = 128
    player_radius_wu: float = 0.125
    position_increment_wu: float = 0.125
    semi_field_of_view_wu: float = 2.0 / 3.0
    num_rays: int = 512
    goal_reward: float = 1.0

    pu_per_tu: int = 32
    camera_height_tile_wu: float = 1.0
    height_camera_view_pu: int = 256

    max_dda_steps: int = 0
    obs_type: str = "camera_u32"
    raycast_backend: str = "auto"
    # Scan-DDA unroll factor of the JAX package; no meaning here (accepted
    # and ignored).
    dda_unroll: int = 1
    max_episode_steps: int = 0
    dda_early_exit: bool = False
    wall_texture: str = "none"
    texture_cells: int = 8
    continuous_heading: bool = False
    turn_increment_au: float = 1.0
    dtype: str = "float32"

    def __post_init__(self):
        if self.height_tile_map_tu < 3 or self.width_tile_map_tu < 3:
            raise ValueError("tile map must be at least 3x3 (border walls + interior)")
        if not (0.0 < self.player_radius_wu < 0.5):
            raise ValueError("player_radius_wu must be in (0, 0.5)")
        if self.num_rays < 2:
            raise ValueError("num_rays must be >= 2")
        if self.num_directions < 1:
            raise ValueError("num_directions must be >= 1")
        if self.obs_type not in OBS_TYPES:
            raise ValueError(f"unknown obs_type: {self.obs_type}")
        if self.obs_type == "camera_pal8" and self.wall_texture == "xor":
            from .colors import MAX_TEX_FACTORS

            if self.texture_cells > MAX_TEX_FACTORS:
                raise ValueError(
                    "obs_type 'camera_pal8' with wall_texture 'xor' needs "
                    f"texture_cells <= {MAX_TEX_FACTORS}: the xor gradient "
                    f"has texture_cells distinct brightness factors and the "
                    "extended uint8 palette holds at most "
                    f"{MAX_TEX_FACTORS} per slab color (checker/brick have "
                    "2 factors and always fit)"
                )
        if self.raycast_backend not in RAYCAST_BACKENDS:
            raise ValueError(f"unknown raycast_backend: {self.raycast_backend}")
        if self.wall_texture not in ("none", "checker", "brick", "xor"):
            raise ValueError(f"unknown wall_texture: {self.wall_texture}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unknown dtype: {self.dtype}")
        if not (2 <= self.texture_cells <= 1 << 15):
            raise ValueError(
                "texture_cells must be in [2, 32768] (int32 texel math)"
            )
        # 'auto' never resolves to a kernel for continuous headings, so only
        # an explicit backend can break this rule.
        if self.continuous_heading and self.raycast_backend not in (
            "crossing", "scan", "auto",
        ):
            raise ValueError(
                "continuous_heading requires raycast_backend 'crossing' or "
                "'scan' (the LUT-free general-map backends)"
            )
        if self.turn_increment_au <= 0:
            raise ValueError("turn_increment_au must be > 0")

    # ------------------------------------------------------------------
    # Derived static quantities
    # ------------------------------------------------------------------

    @property
    def H(self) -> int:
        return self.height_tile_map_tu

    @property
    def W(self) -> int:
        return self.width_tile_map_tu

    @property
    def dda_steps(self) -> int:
        if self.max_dda_steps > 0:
            return self.max_dda_steps
        return self.height_tile_map_tu + self.width_tile_map_tu

    # The JAX package's TPU crossover.  It does not carry over to the H100
    # and resolved_raycast_backend does not read it: the H100 crossover
    # between the CUDA kernel and the plain crossing cast is measured later.
    KERNEL_MIN_RAYS = 256
    KERNEL_MAX_CANDIDATES = 96

    def resolved_raycast_backend(self, device_type: str) -> str:
        """'auto' resolved for the device the state lives on.

        On a CUDA device every float32, discrete-heading config whose packed
        map fits the kernels' shared memory (``KERNEL_MAX_WORDS``) takes the
        hand-written ``crossing_kernel``; everything else, and every CPU
        tensor, takes the plain ``crossing`` cast.  Explicit choices are
        never overridden: a kernel asked for by name raises where it cannot
        run.
        """
        if self.raycast_backend != "auto":
            return self.raycast_backend
        if (
            device_type == "cuda"
            and self.dtype == "float32"
            and not self.continuous_heading
            and -(-self.H * self.W // 32) <= KERNEL_MAX_WORDS
        ):
            return "crossing_kernel"
        return "crossing"

    @property
    def obs_shape(self) -> Tuple[int, ...]:
        if self.obs_type in (
            "camera_u32", "camera_gray", "camera_pal8", "camera_gray_u8"
        ):
            return (self.height_camera_view_pu, self.num_rays)
        if self.obs_type == "camera_rgb":
            return (self.height_camera_view_pu, self.num_rays, 3)
        if self.obs_type == "depth":
            return (self.num_rays,)
        if self.obs_type == "tile_grid":
            return (self.height_tile_map_tu, self.width_tile_map_tu)
        if self.obs_type == "top_u32":
            return self.top_view_shape
        if self.obs_type == "top_rgb":
            return self.top_view_shape + (3,)
        raise AssertionError(self.obs_type)

    @property
    def top_view_shape(self) -> Tuple[int, int]:
        return (
            self.height_tile_map_tu * self.pu_per_tu,
            self.width_tile_map_tu * self.pu_per_tu,
        )

    # ------------------------------------------------------------------
    # Host-side constants, computed in float64 then cast, exactly as the
    # JAX package computes them (the fixed-seed parity depends on both
    # packages embedding the same bits).
    # ------------------------------------------------------------------

    @property
    def float_dtype(self):
        """NumPy dtype of the geometry precision (EnvConfig.dtype)."""
        return np.float64 if self.dtype == "float64" else np.float32

    @functools.cached_property
    def directions_wu(self) -> np.ndarray:
        """[num_directions, 2] unit vectors (cfg dtype); au*2*pi/D, 0 = +x."""
        d = self.num_directions
        theta = np.arange(d, dtype=np.float64) * (2.0 * math.pi / d)
        return np.stack(
            [np.cos(theta), np.sin(theta)], axis=-1
        ).astype(self.float_dtype)

    @property
    def player_radius_pu(self) -> int:
        """Player radius in pixels for the top view."""
        return int(math.floor(self.player_radius_wu * self.pu_per_tu))

    @functools.cached_property
    def ray_fan_lut(self) -> np.ndarray:
        """[num_directions, num_rays, 2] normalized ray directions: rays lerp
        across the camera plane from ``dir + sfov*cam`` to ``dir - sfov*cam``
        with ``cam = rotate_minus_90(dir)``, then normalize (float64, cast
        once)."""
        d = self.num_directions
        r = self.num_rays
        theta = np.arange(d, dtype=np.float64) * (2.0 * math.pi / d)
        dirs = np.stack([np.cos(theta), np.sin(theta)], axis=-1)  # [D, 2]
        cam = np.stack([dirs[:, 1], -dirs[:, 0]], axis=-1)        # [D, 2]
        s = float(self.semi_field_of_view_wu)
        first = dirs + s * cam                                    # [D, 2]
        last = dirs - s * cam
        t = (np.arange(r, dtype=np.float64) / (r - 1))[None, :, None]
        un = first[:, None, :] + t * (last - first)[:, None, :]   # [D, R, 2]
        un /= np.linalg.norm(un, axis=-1, keepdims=True)
        return un.astype(self.float_dtype)

    @functools.cached_property
    def ray_fan_lut_flipped(self) -> np.ndarray:
        """``ray_fan_lut`` with the ray axis reversed (the camera mirror)."""
        return np.ascontiguousarray(self.ray_fan_lut[:, ::-1, :])

    @functools.cached_property
    def palette_np(self) -> np.ndarray:
        """uint32[N] render palette of pal8 observations: the 12-entry base
        palette, extended by the 6 slab colours x F brightness factors when
        a wall texture is on (``colors.build_texture_palette``)."""
        from . import colors

        if self.wall_texture == "none":
            return colors.PALETTE_NP
        return colors.build_texture_palette(self.wall_texture, self.texture_cells)

    @functools.cached_property
    def palette_rgb_f32(self) -> np.ndarray:
        """[N, 3] float32 RGB decode table of ``palette_np``."""
        from . import colors

        return colors.palette_rgb_f32(self.palette_np)

    @functools.cached_property
    def border_wall_map(self) -> np.ndarray:
        """[H, W] bool -- walls on the border."""
        m = np.zeros((self.H, self.W), dtype=bool)
        m[0, :] = m[-1, :] = True
        m[:, 0] = m[:, -1] = True
        return m

    @functools.cached_property
    def border_wall_words(self) -> np.ndarray:
        """Bit-packed ``border_wall_map`` (uint32[ceil(H*W/32)])."""
        from .ops.bitmap import pack_bits_np

        return pack_bits_np(self.border_wall_map)


def replace(cfg: EnvConfig, **kw) -> EnvConfig:
    """A copy of ``cfg`` (of its own config class) with the fields ``kw``
    changed, validated again."""
    return dataclasses.replace(cfg, **kw)
