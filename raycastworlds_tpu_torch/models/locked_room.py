"""LockedRoom: collect the key, then the goal.

A full-height line of door tiles at a fixed interior column splits the room;
the goal spawns on the far side, the player and a key tile on the near side.
Doors are solid (movement and raycast) and render in the block shades until
the key is collected, then vanish for the rest of the episode.  The key
renders in the goal shades: contact collects it (no reward) and blocks the
move for that step, as the goal does.

Doors are a host-packed word constant, held on the device and masked by
``key_held``; the key is one one-hot word in the obstacle union.  Every env
resets from its own key split in the JAX package's order (next, goal, key,
spawn, heading).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import rng
from ..config import EnvConfig
from ..ops import collision, sampling
from ..state import EnvState
from .base import Game


@dataclasses.dataclass(frozen=True)
class LockedRoomConfig(EnvConfig):
    # Interior column holding the door line; 0 resolves to W // 2.  Must
    # leave at least one interior column on each side.
    door_col: int = 0

    def __post_init__(self):
        super().__post_init__()
        if self.width_tile_map_tu < 5:
            raise ValueError(
                "LockedRoom needs width_tile_map_tu >= 5 (interior on both "
                "sides of the door line)"
            )
        dc = self.resolved_door_col
        if not (2 <= dc <= self.width_tile_map_tu - 3):
            raise ValueError(
                f"door_col {dc} must be in [2, W-3] so both sides keep "
                "interior tiles"
            )

    @property
    def resolved_door_col(self) -> int:
        return self.door_col if self.door_col else self.width_tile_map_tu // 2

    @functools.cached_property
    def door_words(self) -> np.ndarray:
        """Packed occupancy words of the door line (host constant)."""
        from ..ops.bitmap import pack_bits_np

        m = np.zeros((self.H, self.W), dtype=bool)
        m[1 : self.H - 1, self.resolved_door_col] = True
        return pack_bits_np(m)


class LockedRoom(Game):
    def __init__(self, cfg: LockedRoomConfig):
        if not isinstance(cfg, LockedRoomConfig):
            raise TypeError("LockedRoom requires a LockedRoomConfig")
        super().__init__(cfg)

    def reset_batch(self, keys: torch.Tensor) -> EnvState:
        cfg: LockedRoomConfig = self.cfg
        h, w = cfg.H, cfg.W
        dc = cfg.resolved_door_col
        dev = keys.device
        b = keys.shape[0]
        sub = rng.split(keys, 5)
        next_key, k_goal, k_key, k_spawn, k_dir = (sub[:, q] for q in range(5))

        goal_tu = rng.randint(k_goal, (2,), [1, dc + 1], [h - 1, w - 1])
        key_tu = rng.randint(k_key, (2,), [1, 1], [h - 1, dc])
        # spawn: uniform over the left interior minus the key tile (the
        # interior draw of a room whose columns end at the door line)
        spawn_tu = sampling.sample_empty_interior_tile(
            k_spawn, h, dc + 1, sampling.interior_rank(key_tu, dc + 1)[:, None])

        pos_wu, dir_au = self._spawn_pose(spawn_tu, k_dir)
        zeros_f = torch.zeros(b, dtype=torch.float32, device=dev)
        falses = torch.zeros(b, dtype=torch.bool, device=dev)
        return EnvState(
            wall_words=self._words_batch("border_wall_words", b, dev),
            goal_tu=goal_tu,
            key_tu=key_tu,
            key_held=falses.clone(),
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

    def _door_words(self, state: EnvState) -> torch.Tensor:
        """int32[B, nw] door occupancy, all-zero once the key is held."""
        doors = self._table("door_words", state.device)[None, :]
        return torch.where(state.key_held[:, None], 0, doors)

    def _block_words_batch(self, state: EnvState) -> torch.Tensor:
        """Doors render in the block shades."""
        return self._door_words(state)

    def _packed_maps_batch(self, state: EnvState):
        """Obstacles: walls, goal, doors and the key until it is held."""
        walls, obstacle = super()._packed_maps_batch(state)
        key_word = self._tile_word(state.key_tu, walls.shape[-1])
        key_word = torch.where(state.key_held[:, None], 0, key_word)
        return walls, obstacle | self._door_words(state) | key_word

    def step_batch(self, state: EnvState, action: torch.Tensor) -> EnvState:
        moving, cand = self._move_candidate(state, action)
        hit_key = moving & ~state.key_held & collision.is_colliding_with_goal(
            cand, state.key_tu, self.cfg.player_radius_wu)
        solid = state.wall_words | self._door_words(state)
        stepped = self._goal_step(state, action, moving, cand, solid, stop=hit_key)
        return stepped.replace(key_held=state.key_held | hit_key)


def make(cfg: LockedRoomConfig | None = None, **kw) -> LockedRoom:
    return LockedRoom(cfg if cfg is not None else LockedRoomConfig(**kw))
