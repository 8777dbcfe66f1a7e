"""DynamicRoom: SingleRoom plus K moving blocks.

Blocks are unit tiles that patrol in a cardinal direction, advancing one
tile every ``block_period`` steps and reversing (``dir ^ 1``) off walls, the
goal, other blocks' current tiles and the player circle.  They are solid
for the player and the raycaster and render in the block shades.

``EnvState.blocks`` is int32[B, K, 3]: rows (i, j, dir) with dir over
(N, S, W, E) = ((-1, 0), (1, 0), (0, -1), (0, 1)).  Every env resets from
its own key split in the JAX package's order (next, goal, blocks, block
directions, spawn, heading).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import rng
from ..config import EnvConfig
from ..ops import bitmap, collision, sampling
from ..state import EnvState
from .base import Game

@dataclasses.dataclass(frozen=True)
class DynamicRoomConfig(EnvConfig):
    num_blocks: int = 3
    block_period: int = 4  # blocks advance one tile every this many steps

    def __post_init__(self):
        super().__post_init__()
        interior = (self.height_tile_map_tu - 2) * (self.width_tile_map_tu - 2)
        if not (1 <= self.num_blocks < interior - 1):
            raise ValueError("num_blocks out of range for this map size")
        if self.block_period < 1:
            raise ValueError("block_period must be >= 1")


class DynamicRoom(Game):
    supports_analytic_raycast = True  # border ring + K blocks + 1 goal box

    def __init__(self, cfg: DynamicRoomConfig):
        if not isinstance(cfg, DynamicRoomConfig):
            raise TypeError("DynamicRoom requires a DynamicRoomConfig")
        super().__init__(cfg)

    def _analytic_boxes(self, state: EnvState) -> torch.Tensor:
        return torch.cat([state.blocks[..., :2], state.goal_tu[:, None, :]], dim=1)

    def reset_batch(self, keys: torch.Tensor) -> EnvState:
        cfg: DynamicRoomConfig = self.cfg
        h, w = cfg.H, cfg.W
        dev = keys.device
        b = keys.shape[0]
        sub = rng.split(keys, 6)
        next_key, k_goal, k_blocks, k_dirs, k_spawn, k_dir = (sub[:, q] for q in range(6))

        goal_tu = sampling.sample_interior_tile(k_goal, h, w)
        tiles, ranks = sampling.sample_distinct_interior_tiles(
            rng.split(k_blocks, cfg.num_blocks), h, w,
            [sampling.interior_rank(goal_tu, w)])
        dirs = rng.randint(k_dirs, (cfg.num_blocks,), 0, 4)
        blocks = torch.cat([tiles, dirs[..., None]], dim=-1)         # [B, K, 3]
        spawn_tu = sampling.sample_empty_interior_tile(
            k_spawn, h, w, torch.stack(ranks, dim=-1))

        pos_wu, dir_au = self._spawn_pose(spawn_tu, k_dir)
        zeros_f = torch.zeros(b, dtype=torch.float32, device=dev)
        falses = torch.zeros(b, dtype=torch.bool, device=dev)
        return EnvState(
            wall_words=self._words_batch("border_wall_words", b, dev),
            goal_tu=goal_tu,
            blocks=blocks,
            pos_wu=pos_wu,
            dir_au=dir_au,
            reward=zeros_f,
            done=falses,
            rng_key=next_key.contiguous(),
            t=torch.zeros(b, dtype=torch.int32, device=dev),
            episode_return=zeros_f.clone(),
            pending_reset=falses.clone(),
            hw=(h, w),
        )

    def _advance_blocks(self, state: EnvState) -> torch.Tensor:
        """One block tick: every block advances, or reverses where its next
        tile is a wall, the goal, another block's current tile (blocks move
        simultaneously) or overlaps the player circle."""
        cfg: DynamicRoomConfig = self.cfg
        h, w = cfg.H, cfg.W
        blocks = state.blocks
        tile, bdir = blocks[..., :2], blocks[..., 2]
        # the step of dir (N, S, W, E) = ((-1, 0), (1, 0), (0, -1), (0, 1))
        di = torch.where(bdir == 0, -1, torch.where(bdir == 1, 1, 0))
        dj = torch.where(bdir == 2, -1, torch.where(bdir == 3, 1, 0))
        cand = tile + torch.stack([di, dj], dim=-1).to(torch.int32)  # [B, K, 2]
        idx = torch.clamp(cand[..., 0], 0, h - 1) * w + torch.clamp(cand[..., 1], 0, w - 1)
        into_wall = bitmap.lookup_bit(state.wall_words, idx)
        into_goal = (cand == state.goal_tu[:, None, :]).all(dim=-1)
        into_block = (cand[:, :, None, :] == tile[:, None, :, :]).all(dim=-1).any(dim=-1)
        into_player = collision.is_colliding_tile(
            state.pos_wu[:, None, :], cand, cfg.player_radius_wu)
        blocked = into_wall | into_goal | into_block | into_player
        new_tile = torch.where(blocked[..., None], tile, cand)
        new_dir = torch.where(blocked, bdir ^ 1, bdir)
        return torch.cat([new_tile, new_dir[..., None]], dim=-1)

    def step_batch(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """Blocks tick first (on steps where t+1 is a multiple of the
        period), then the player acts against the moved blocks."""
        tick = torch.remainder(state.t + 1, self.cfg.block_period) == 0
        state = state.replace(
            blocks=torch.where(tick[:, None, None], self._advance_blocks(state), state.blocks))
        moving, cand = self._move_candidate(state, action)
        solid = state.wall_words | self._block_words_batch(state)
        return self._goal_step(state, action, moving, cand, solid)

    def _block_words_batch(self, state: EnvState) -> torch.Tensor:
        return bitmap.tiles_to_words(
            state.blocks, (self.cfg.H, self.cfg.W), state.wall_words.shape[-1])

    def _packed_maps_batch(self, state: EnvState):
        """Obstacles: walls, goal and blocks."""
        walls, obstacle = super()._packed_maps_batch(state)
        return walls, obstacle | self._block_words_batch(state)


def make(cfg: DynamicRoomConfig | None = None, **kw) -> DynamicRoom:
    return DynamicRoom(cfg if cfg is not None else DynamicRoomConfig(**kw))
