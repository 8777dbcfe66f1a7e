"""MultiGoalRoom: a walled room with K goal tiles.

The goals live in a packed goal mask (``EnvState.goal_words``, the walls'
word layout), kept in sync with the list of goal tiles
(``EnvState.goal_tiles``, collected goals at (-1, -1)).  The obstacle union
ORs the mask in; the renderer's slab colour falls through to the goal shades
wherever the hit tile is not a wall.

* ``collect_all=True`` (default): touching goals pays ``goal_reward`` per
  goal touched and clears them; the episode ends when all K are collected.
* ``collect_all=False``: touching any goal terminates.

Touching a goal never moves the player.  Every env resets from its own key
split in the JAX package's order (next, goals, spawn, heading).
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
class MultiGoalConfig(EnvConfig):
    num_goals: int = 3
    collect_all: bool = True

    def __post_init__(self):
        super().__post_init__()
        interior = (self.height_tile_map_tu - 2) * (self.width_tile_map_tu - 2)
        if not (1 <= self.num_goals < interior):
            raise ValueError(
                f"num_goals must be in [1, {interior}) for this map size"
            )


class MultiGoalRoom(Game):
    supports_analytic_raycast = True  # border ring + K unit boxes

    def __init__(self, cfg: MultiGoalConfig):
        if not isinstance(cfg, MultiGoalConfig):
            raise TypeError("MultiGoalRoom requires a MultiGoalConfig")
        super().__init__(cfg)

    def _analytic_boxes(self, state: EnvState) -> torch.Tensor:
        return state.goal_tiles

    def reset_batch(self, keys: torch.Tensor) -> EnvState:
        cfg: MultiGoalConfig = self.cfg
        h, w = cfg.H, cfg.W
        dev = keys.device
        b = keys.shape[0]
        sub = rng.split(keys, 4)
        next_key, k_goals, k_spawn, k_dir = (sub[:, q] for q in range(4))

        wall_words = self._words_batch("border_wall_words", b, dev)
        goal_tiles, ranks = sampling.sample_distinct_interior_tiles(
            rng.split(k_goals, cfg.num_goals), h, w)
        goal_words = bitmap.tiles_to_words(goal_tiles, (h, w), wall_words.shape[-1])
        spawn_tu = sampling.sample_empty_interior_tile(
            k_spawn, h, w, torch.stack(ranks, dim=-1))

        pos_wu, dir_au = self._spawn_pose(spawn_tu, k_dir)
        zeros_f = torch.zeros(b, dtype=torch.float32, device=dev)
        falses = torch.zeros(b, dtype=torch.bool, device=dev)
        return EnvState(
            wall_words=wall_words,
            goal_tu=goal_tiles[:, 0].contiguous(),
            goal_words=goal_words,
            goal_tiles=goal_tiles,
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

    def step_batch(self, state: EnvState, action: torch.Tensor) -> EnvState:
        cfg: MultiGoalConfig = self.cfg
        moving, cand = self._move_candidate(state, action)
        r = cfg.player_radius_wu
        shape = (cfg.H, cfg.W)
        dev = state.device

        touched = collision.colliding_occupied_words(state.goal_words, shape, cand, r)
        touched = torch.where(moving[:, None], touched, 0)
        n_hit = bitmap.popcount(touched).sum(dim=-1, dtype=torch.int32)
        hit_goal = n_hit > 0
        hit_wall = moving & collision.is_player_colliding_packed(
            state.wall_words, shape, cand, r)

        goal_reward = self._reward_const(cfg.goal_reward, state)
        if cfg.collect_all:
            goal_words = state.goal_words & ~touched
            reward = n_hit.to(goal_reward.dtype) * goal_reward
            done = ~(goal_words != 0).any(dim=-1)
            # keep the tile list in sync: collected rows become (-1, -1)
            tiles = state.goal_tiles
            gidx = tiles[..., 0] * cfg.W + tiles[..., 1]
            row_touched = (tiles[..., 0] >= 0) & bitmap.lookup_bit(
                touched, torch.clamp(gidx, 0, cfg.H * cfg.W - 1))
            goal_tiles = torch.where(row_touched[..., None], -1, tiles)
        else:
            goal_words = state.goal_words
            goal_tiles = state.goal_tiles
            reward = torch.where(hit_goal, goal_reward, self._reward_const(0, state))
            done = hit_goal

        commit = moving & ~hit_goal & ~hit_wall
        return state.replace(
            pos_wu=torch.where(commit[:, None], cand, state.pos_wu),
            dir_au=self._turned_dir(state, action, moving),
            goal_words=goal_words,
            goal_tiles=goal_tiles,
            reward=reward,
            done=done,
            t=state.t + 1,
            episode_return=state.episode_return + reward,
        )

    def _packed_maps_batch(self, state: EnvState):
        """Obstacles: the walls and the goals not yet collected."""
        return state.wall_words, state.wall_words | state.goal_words


def make(cfg: MultiGoalConfig | None = None, **kw) -> MultiGoalRoom:
    return MultiGoalRoom(cfg if cfg is not None else MultiGoalConfig(**kw))
