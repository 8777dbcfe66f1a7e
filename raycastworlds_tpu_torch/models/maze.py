"""Maze: a binary-tree maze with rectangular rooms, new per episode.

Cells sit at odd coordinates of an odd-sized map (``H = 2*CH+1``,
``W = 2*CW+1``).  Every cell carves a passage north or west by one coin
(edge cells have no choice), which yields a perfect maze from one vectorized
draw; ``num_rooms`` random rectangles are then cleared, which keeps every
tile connected, so the goal is always reachable.  Goal and spawn are two
draws over the empty tiles.  Dynamics are SingleRoom's; every env resets
from its own key split in the JAX package's order (next, map, goal, spawn,
heading).

On the card the reset is one launch of the CUDA kernel
``csrc/maze_reset.cu`` (counted as ``kernel_launches.maze_reset``), which
writes every field of the fresh state; any other key takes the plain
version, :meth:`Maze.reset_batch_plain` in torch ops (about 340 launches a
call on the card), which the tests hold the kernel to bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import cuda_build, rng
from ..config import EnvConfig
from ..ops import bitmap, sampling
from ..state import LEAVES, EnvState
from ..utils import profiling
from .base import Game

# Words of one maze's packed map (``ceil(H * W / 32)``) the kernel holds in
# shared memory (``kMaxWords`` in ``csrc/maze_reset.cu``): every map up to
# 361 x 361 tiles.
KERNEL_MAX_WORDS = 4096


@dataclasses.dataclass(frozen=True)
class MazeConfig(EnvConfig):
    """EnvConfig + maze-carving knobs.  H and W must be odd (cells at odd
    coordinates)."""

    height_tile_map_tu: int = 17
    width_tile_map_tu: int = 17
    num_rooms: int = 3           # rectangular rooms carved into the maze
    room_max_half_tu: int = 2    # max room half-extent in tiles

    def __post_init__(self):
        super().__post_init__()
        if self.height_tile_map_tu % 2 == 0 or self.width_tile_map_tu % 2 == 0:
            raise ValueError("maze dimensions must be odd (cells at odd coords)")
        if self.height_tile_map_tu < 5 or self.width_tile_map_tu < 5:
            raise ValueError("maze needs at least 2x2 cells (>= 5x5 tiles)")
        if self.num_rooms < 0:
            raise ValueError("num_rooms must be >= 0")


def _uses_kernel(keys: torch.Tensor) -> bool:
    """The reset's dispatch: a CUDA key goes to the kernel (or raises), any
    other takes the plain version."""
    return keys.device.type == "cuda"


def _maze_reset_kernel(cfg: MazeConfig, keys: torch.Tensor) -> EnvState:
    """The CUDA kernel's reset: one launch that writes every leaf of a state
    allocated empty, no host read.  Raises on inputs the kernel does not
    take: keys other than int64[B, 2], a map of more than KERNEL_MAX_WORDS
    words, or a ``room_max_half_tu`` whose bound ``room_max_half_tu + 1`` is
    outside int32."""
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be int64 [B, 2], not {keys.dtype} {list(keys.shape)}")
    h, w = cfg.H, cfg.W
    nw = bitmap.n_words(h * w)
    if nw > KERNEL_MAX_WORDS:
        raise ValueError(f"a {h} x {w} maze is {nw} words (ceil(H * W / 32)), more than the "
                         f"maze reset kernel holds (KERNEL_MAX_WORDS = {KERNEL_MAX_WORDS})")
    if not -(2**31) <= cfg.room_max_half_tu + 1 < 2**31:
        raise ValueError("room_max_half_tu + 1 must fit in int32")
    b, dev = keys.shape[0], keys.device
    f64 = cfg.dtype == "float64"
    state = EnvState(
        wall_words=torch.empty((b, nw), dtype=torch.int32, device=dev),
        goal_tu=torch.empty((b, 2), dtype=torch.int32, device=dev),
        pos_wu=torch.empty((b, 2), dtype=torch.float64 if f64 else torch.float32, device=dev),
        dir_au=torch.empty(b, dtype=torch.float32 if cfg.continuous_heading else torch.int32,
                           device=dev),
        reward=torch.empty(b, dtype=torch.float32, device=dev),
        done=torch.empty(b, dtype=torch.bool, device=dev),
        rng_key=torch.empty((b, 2), dtype=torch.int64, device=dev),
        t=torch.empty(b, dtype=torch.int32, device=dev),
        episode_return=torch.empty(b, dtype=torch.float32, device=dev),
        pending_reset=torch.empty(b, dtype=torch.bool, device=dev),
        hw=(h, w),
    )
    if b == 0:
        return state
    lib = cuda_build.load()
    cuda_build.launch(lib.rcw_maze_reset, dev, keys.data_ptr(), keys.stride(0), keys.stride(1),
                      *(getattr(state, leaf).data_ptr() for leaf in LEAVES), b, h, w,
                      cfg.num_rooms, cfg.room_max_half_tu, cfg.num_directions,
                      int(cfg.continuous_heading), int(f64), what="maze reset")
    return state


class Maze(Game):
    def __init__(self, cfg: MazeConfig):
        if not isinstance(cfg, MazeConfig):
            raise TypeError("Maze requires a MazeConfig")
        super().__init__(cfg)

    def _generate_walls(self, k_map: torch.Tensor) -> torch.Tensor:
        """bool[B, H, W] maze walls from per-env keys [B, 2]."""
        cfg: MazeConfig = self.cfg
        h, w = cfg.H, cfg.W
        ch, cw = (h - 1) // 2, (w - 1) // 2
        dev = k_map.device
        b = k_map.shape[0]

        sub = rng.split(k_map)
        k_coin, k_rooms = sub[:, 0], sub[:, 1]
        coin = rng.bernoulli(k_coin, 0.5, (ch, cw))               # [B, CH, CW]
        ci = torch.arange(ch, device=dev)[:, None]
        cj = torch.arange(cw, device=dev)[None, :]
        # binary-tree rule: north when possible and (no west option or coin)
        carve_north = (ci > 0) & ((cj == 0) | coin)
        carve_west = (cj > 0) & ~carve_north

        wall = torch.ones((b, h, w), dtype=torch.bool, device=dev)
        wall[:, 1::2, 1::2] = False                               # cells
        wall[:, 2:h - 1:2, 1::2] = ~carve_north[:, 1:, :]         # north passages
        wall[:, 1::2, 2:w - 1:2] = ~carve_west[:, :, 1:]          # west passages

        if cfg.num_rooms > 0:
            ii = torch.arange(h, device=dev)[None, :, None]
            jj = torch.arange(w, device=dev)[None, None, :]
            interior = (ii > 0) & (ii < h - 1) & (jj > 0) & (jj < w - 1)
            keys = rng.split(k_rooms, cfg.num_rooms)              # [B, rooms, 2]
            for k in range(cfg.num_rooms):
                ks = rng.split(keys[:, k])
                center = rng.randint(ks[:, 0], (2,), [1, 1], [h - 1, w - 1])
                half = rng.randint(ks[:, 1], (2,), 1, cfg.room_max_half_tu + 1)
                room = (
                    (torch.abs(ii - center[:, 0, None, None]) <= half[:, 0, None, None])
                    & (torch.abs(jj - center[:, 1, None, None]) <= half[:, 1, None, None])
                    & interior
                )
                wall = wall & ~room
        return wall

    @profiling.span("rcw.game.maze_reset")
    def reset_batch(self, keys: torch.Tensor) -> EnvState:
        """A fresh maze per key [B, 2] (counted as ``maze_maps``).  A CUDA
        key launches the kernel; any other takes :meth:`reset_batch_plain`."""
        profiling.count("maze_maps", keys.shape[0])
        if _uses_kernel(keys):
            return _maze_reset_kernel(self.cfg, keys)
        return self.reset_batch_plain(keys)

    def reset_batch_plain(self, keys: torch.Tensor) -> EnvState:
        """:meth:`reset_batch` in torch ops on any device: the carve,
        :func:`sampling.sample_empty_tile_pair`, the spawn pose and
        :func:`bitmap.pack_bits`."""
        cfg: MazeConfig = self.cfg
        dev = keys.device
        b = keys.shape[0]
        sub = rng.split(keys, 5)
        next_key, k_map, k_goal, k_spawn, k_dir = (sub[:, q] for q in range(5))

        wall_map = self._generate_walls(k_map)
        goal_tu, spawn_tu = sampling.sample_empty_tile_pair(k_goal, k_spawn, wall_map)

        pos_wu, dir_au = self._spawn_pose(spawn_tu, k_dir)
        zeros_f = torch.zeros(b, dtype=torch.float32, device=dev)
        falses = torch.zeros(b, dtype=torch.bool, device=dev)
        return EnvState(
            wall_words=bitmap.pack_bits(wall_map),
            goal_tu=goal_tu,
            pos_wu=pos_wu,
            dir_au=dir_au,
            reward=zeros_f,
            done=falses,
            rng_key=next_key.contiguous(),
            t=torch.zeros(b, dtype=torch.int32, device=dev),
            episode_return=zeros_f.clone(),
            pending_reset=falses.clone(),
            hw=(cfg.H, cfg.W),
        )


def make(cfg: MazeConfig | None = None, **kw) -> Maze:
    return Maze(cfg if cfg is not None else MazeConfig(**kw))
