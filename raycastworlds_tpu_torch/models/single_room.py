"""SingleRoom: a walled rectangular room with one goal tile and a circular
player.  Reset draws, per env, a goal uniform over the interior, a spawn
uniform over the empty tiles and a heading uniform over the angle units,
from the env's key split in the JAX package's order (next, goal, spawn,
heading), so both packages reset every env to the same state.
"""

from __future__ import annotations

import torch

from .. import rng
from ..config import EnvConfig
from ..ops import sampling
from ..state import EnvState
from .base import Game


class SingleRoom(Game):
    supports_analytic_raycast = True  # border ring + the goal box

    def reset_batch(self, keys: torch.Tensor) -> EnvState:
        cfg = self.cfg
        dev = keys.device
        b = keys.shape[0]
        sub = rng.split(keys, 4)                                  # [B, 4, 2]
        next_key, k_goal, k_spawn, k_dir = (sub[:, q] for q in range(4))

        wall_words = self._words_batch("border_wall_words", b, dev)
        goal_tu = sampling.sample_interior_tile(k_goal, cfg.H, cfg.W)
        # Spawn: uniform over interior tiles minus the goal, in closed form.
        spawn_tu = sampling.sample_empty_interior_tile(
            k_spawn, cfg.H, cfg.W, sampling.interior_rank(goal_tu, cfg.W)[:, None])
        pos_wu, dir_au = self._spawn_pose(spawn_tu, k_dir)        # tile centre

        zeros_f = torch.zeros(b, dtype=torch.float32, device=dev)
        falses = torch.zeros(b, dtype=torch.bool, device=dev)
        return EnvState(
            wall_words=wall_words,
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


def make(cfg: EnvConfig | None = None, **kw) -> SingleRoom:
    return SingleRoom(cfg if cfg is not None else EnvConfig(**kw))
