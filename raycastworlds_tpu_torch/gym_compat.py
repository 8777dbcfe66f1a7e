"""Gymnasium-style adapters over the batched :class:`Env`.

The port of the JAX package's ``gym_compat.py``.  The batched ``Env`` is
the native API; these adapters give the imperative single-env and vector-env
interfaces that host-loop RL libraries drive, with no gymnasium dependency
but gymnasium's method contract (reset -> (obs, info), step -> (obs,
reward, terminated, truncated, info), render -> RGB array).

The env runs on ``device`` (the CUDA device by default, as ``Env``); the
returned arrays are numpy, one host copy per array.  Seeds follow the
gymnasium contract as in the JAX package: an explicit seed re-seeds the key
stream, ``seed=None`` continues it through ``rng.split``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import rng
from .colors import u32_to_rgb
from .env import Env
from .models.base import Game
from .utils import profiling, to_numpy


def _single_agent(game: Game, name: str, what: str) -> None:
    if getattr(game, "action_shape", ()) != ():
        raise ValueError(
            f"{name} is single-agent ({what}); drive MultiPlayerRoom through "
            "the batched Env API instead"
        )


class GymAdapter:
    """Imperative single-env facade over ``Env(num_envs=1, auto_reset=False)``."""

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, game: Game, max_episode_steps: Optional[int] = None, device=None):
        _single_agent(game, "GymAdapter", "scalar action/reward per env")
        self._env = Env(game, num_envs=1, auto_reset=False, device=device)
        self._state = None
        self._key = rng.PRNGKey(0)
        self._max_steps = max_episode_steps
        self.action_space = self._env.action_space
        self.observation_space = self._env.observation_space

    def reset(
        self, seed: Optional[int] = None, options: Optional[dict] = None
    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        if seed is not None:
            self._key = rng.PRNGKey(seed)
        self._key, k_reset = rng.split(self._key).unbind(0)
        self._state, obs = self._env.reset(k_reset)
        return to_numpy(obs[0]), {}

    @profiling.span("rcw.gym.step")
    def step(self, action: int):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        res = self._env.step(self._state, torch.tensor([int(action)], dtype=torch.int32))
        self._state = res.state
        with profiling.span("rcw.gym.to_host"):
            info = {k: to_numpy(v[0]) for k, v in res.info.items()}
            obs, reward = to_numpy(res.obs[0]), float(res.reward[0])
        terminated = bool(info["terminated"])
        truncated = bool(info["truncated"]) or (
            self._max_steps is not None
            and int(res.state.t[0]) >= self._max_steps
            and not terminated
        )
        return obs, reward, terminated, truncated, info

    def render(self) -> np.ndarray:
        """uint8 RGB frame [H, W, 3] of the camera view."""
        return u32_to_rgb(to_numpy(self._env.camera_view(self._state)[0]))

    def close(self) -> None:
        self._state = None


class GymVectorAdapter:
    """Imperative vectorized facade with the gymnasium.vector.VectorEnv
    contract (reset -> (obs[N], info), step -> (obs[N], reward[N],
    terminated[N], truncated[N], info)) and autoreset: the obs returned for
    a finished env already belongs to its next episode, while
    reward/terminated/truncated describe the finishing transition, which is
    what the batched :class:`Env` computes.  The step stays on the device;
    only the returned arrays cross to the host, each once (``terminated``
    and ``truncated`` are the info dict's arrays).
    """

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(
        self,
        game: Game,
        num_envs: int,
        reset_budget: int = 0,
        final_observation: bool = False,
        device=None,
    ):
        """``final_observation=True`` adds ``info["final_observation"]``, the
        pre-reset obs of every env (meaningful where terminated|truncated is
        set), at the cost of a second cast and render per step."""
        _single_agent(game, "GymVectorAdapter", "scalar action per env")
        self.num_envs = num_envs
        self._env = Env(
            game, num_envs=num_envs, auto_reset=True, device=device,
            reset_budget=reset_budget, final_obs_in_info=final_observation,
        )
        self._state = None
        self._key = rng.PRNGKey(0)
        self.single_action_space = self._env.action_space
        self.single_observation_space = self._env.observation_space

    def reset(
        self, seed: Optional[int] = None, options: Optional[dict] = None
    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        if seed is not None:
            self._key = rng.PRNGKey(seed)
        self._key, k_reset = rng.split(self._key).unbind(0)
        self._state, obs = self._env.reset(k_reset)
        return to_numpy(obs), {}

    @profiling.span("rcw.gym.step")
    def step(self, actions):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        if not torch.is_tensor(actions):
            actions = torch.from_numpy(np.asarray(actions).astype(np.int32))
        res = self._env.step(self._state, actions)
        self._state = res.state
        with profiling.span("rcw.gym.to_host"):
            info = {k: to_numpy(v) for k, v in res.info.items()}
            obs, reward = to_numpy(res.obs), to_numpy(res.reward)
        return obs, reward, info["terminated"], info["truncated"], info

    def render(self) -> np.ndarray:
        """uint8 RGB frames [N, H, W, 3] of the camera views."""
        return u32_to_rgb(to_numpy(self._env.camera_view(self._state)))

    def close(self) -> None:
        self._state = None
