"""Game base class: the batched step / cast / observe shared by the world
families.  A ``Game`` carries the static ``EnvConfig`` and per-device copies
of its lookup tables; all dynamics are functions of ``(EnvState, action)``
over the leading env axis.  Subclasses provide ``reset_batch``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import MOVE_FORWARD, TURN_LEFT, TURN_RIGHT, EnvConfig
from ..ops import collision, lut, raycast, render
from ..state import EnvState


def _check_ported(cfg: EnvConfig) -> None:
    if cfg.dtype != "float32" or cfg.continuous_heading:
        raise NotImplementedError(
            "float64 and continuous headings are not ported yet "
            "(ROADMAP Queue 1 item 16)"
        )
    if cfg.raycast_backend not in ("auto", "crossing", "crossing_kernel"):
        raise NotImplementedError(
            f"raycast_backend {cfg.raycast_backend!r} is not ported yet "
            f"({raycast._BACKEND_ITEM[cfg.raycast_backend]})"
        )


class Game:
    """Base game over the generic grid-world dynamics."""

    num_actions = 4
    # Trailing per-env action shape: () for single-player families.
    action_shape: tuple = ()

    def __init__(self, cfg: EnvConfig):
        _check_ported(cfg)
        self.cfg = cfg
        self._tables: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    def _table(self, name: str, device: torch.device) -> torch.Tensor:
        """The config's host LUT ``name`` as a tensor on ``device``."""
        key = (name, device)
        if key not in self._tables:
            host = np.ascontiguousarray(getattr(self.cfg, name))
            self._tables[key] = torch.from_numpy(host).to(device)
        return self._tables[key]

    # -- per-family -----------------------------------------------------

    def reset_batch(self, keys: torch.Tensor) -> EnvState:
        """Fresh states from per-env keys int64[B, 2]."""
        raise NotImplementedError

    # -- heading --------------------------------------------------------

    def _player_dir(self, state: EnvState) -> torch.Tensor:
        return lut.take_rows(self._table("directions_wu", state.device), state.dir_au)

    def _ray_dirs(self, state: EnvState) -> torch.Tensor:
        return lut.take_rows(self._table("ray_fan_lut", state.device), state.dir_au)

    # -- shared dynamics ------------------------------------------------

    def step_batch(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """One action per env, branch-free:

        * actions 0/1 translate along the heading vector; the candidate
          position is tested against the goal and the walls separately; a
          goal hit pays ``goal_reward`` and terminates without moving; a
          wall hit blocks; otherwise the move commits.
        * actions 2/3 turn by +/-1 angle unit, modular.
        * ``done``/``reward`` are re-derived every step (not sticky).
        """
        cfg = self.cfg
        moving, cand = self._move_candidate(state, action)
        r = cfg.player_radius_wu
        hit_goal = moving & collision.is_colliding_with_goal(cand, state.goal_tu, r)
        hit_wall = moving & collision.is_player_colliding_packed(
            state.wall_words, (cfg.H, cfg.W), cand, r
        )
        reward = torch.where(
            hit_goal,
            torch.tensor(np.float32(cfg.goal_reward), device=state.device),
            torch.tensor(np.float32(0), device=state.device),
        )
        commit = (moving & ~hit_goal & ~hit_wall)[:, None]
        return state.replace(
            pos_wu=torch.where(commit, cand, state.pos_wu),
            dir_au=self._turned_dir(state, action, moving),
            reward=reward,
            done=hit_goal,
            t=state.t + 1,
            episode_return=state.episode_return + reward,
        )

    def _move_candidate(self, state: EnvState, action: torch.Tensor):
        """(moving bool[B], candidate position f32[B, 2])."""
        dir_wu = self._player_dir(state)
        moving = action < 2
        sign = torch.where(action == MOVE_FORWARD, 1.0, -1.0).to(torch.float32)
        inc = sign * float(np.float32(self.cfg.position_increment_wu))
        return moving, state.pos_wu + inc[:, None] * dir_wu

    def _turned_dir(self, state: EnvState, action: torch.Tensor, moving):
        """New heading after a turn action."""
        turn = torch.where(
            action == TURN_LEFT, 1, torch.where(action == TURN_RIGHT, -1, 0)
        )
        step = torch.where(moving, 0, turn)
        return torch.remainder(state.dir_au + step, self.cfg.num_directions).to(
            torch.int32
        )

    def _packed_maps_batch(self, state: EnvState):
        """(wall_words, obstacle_words) int32[B, nw]: the obstacle map is
        the walls plus the goal bit."""
        cfg = self.cfg
        wall_words = state.wall_words
        gidx = state.goal_tu[:, 0] * cfg.W + state.goal_tu[:, 1]
        nw = wall_words.shape[-1]
        lane = torch.arange(nw, dtype=torch.int32, device=state.device)[None, :]
        goal_vec = torch.where(
            lane == (gidx[:, None] >> 5),
            torch.ones_like(gidx)[:, None] << (gidx[:, None] & 31),
            0,
        ).to(torch.int32)
        return wall_words, wall_words | goal_vec

    def cast_batch(self, state: EnvState) -> raycast.RayHits:
        """Ray-cast every env's pose through the backend the config resolves
        for the state's device."""
        _, obstacle_words = self._packed_maps_batch(state)
        return raycast.cast_rays(
            self.cfg, obstacle_words, state.pos_wu, self._ray_dirs(state)
        )

    def observe_batch(self, state: EnvState) -> torch.Tensor:
        hits = self.cast_batch(state)
        return render.render_observation(
            self.cfg, state.wall_words, state.goal_tu, self._player_dir(state), hits
        )
