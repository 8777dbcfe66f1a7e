"""Composable environment wrappers: frame stacking and observation
transforms.

The port of the JAX package's ``wrappers.py``.  Each wrapper keeps the
batched functional contract of :class:`Env`: ``reset(key) -> (state,
obs)``, ``step(state, action) -> StepResult``, with auto-reset passing
through, and runs where its env runs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .env import Env, Space, StepResult
from .ops.render import as_i32
from .state import EnvState


class FrameStackState(NamedTuple):
    env_state: EnvState
    frames: torch.Tensor  # [B, n_stack, *obs_shape]


class FrameStack:
    """Stack the last ``n_stack`` observations along a per-env axis.

    On an episode boundary (done) the stack restarts filled with the new
    episode's first observation: no cross-episode leakage.
    """

    def __init__(self, env: Env, n_stack: int = 4):
        if n_stack < 1:
            raise ValueError("n_stack must be >= 1")
        self.env = env
        self.n_stack = n_stack

    @property
    def action_space(self) -> Space:
        return self.env.action_space

    @property
    def observation_space(self) -> Space:
        s = self.env.observation_space
        return Space(shape=(self.n_stack,) + s.shape, dtype=s.dtype)

    def _repeat(self, obs: torch.Tensor) -> torch.Tensor:
        return obs[:, None].expand((obs.shape[0], self.n_stack) + obs.shape[1:]).contiguous()

    def reset(self, key: torch.Tensor):
        state, obs = self.env.reset(key)
        frames = _as_u32(self._repeat(as_i32(obs)), obs)
        return FrameStackState(state, frames), frames

    def step(self, fs: FrameStackState, action: torch.Tensor) -> StepResult:
        res = self.env.step(fs.env_state, action)
        obs = as_i32(res.obs)
        shifted = torch.cat([as_i32(fs.frames)[:, 1:], obs[:, None]], dim=1)
        done = res.done.reshape(res.done.shape + (1,) * (shifted.dim() - res.done.dim()))
        frames = _as_u32(torch.where(done, self._repeat(obs), shifted), res.obs)
        return StepResult(FrameStackState(res.state, frames), frames, res.reward, res.done,
                          res.info)


def _as_u32(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.view(torch.uint32) if like.dtype == torch.uint32 else x


class ObsTransform:
    """Apply a per-batch observation transform (cast, normalize,
    downsample, ...) to an Env's outputs."""

    def __init__(self, env: Env, fn: Callable[[torch.Tensor], torch.Tensor]):
        self.env = env
        self.fn = fn

    @property
    def action_space(self) -> Space:
        return self.env.action_space

    def reset(self, key: torch.Tensor):
        state, obs = self.env.reset(key)
        return state, self.fn(obs)

    def step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        res = self.env.step(state, action)
        return StepResult(res.state, self.fn(res.obs), res.reward, res.done, res.info)


def downsample2x(obs: torch.Tensor) -> torch.Tensor:
    """2x spatial mean pool of [B, H, W] or [B, H, W, C] images, in float32:
    ``0.25 * (((a + b) + c) + d)`` in the JAX package's order, so the result
    is exact against it.  uint32 frames convert through their int32 view
    (colours are below 2**24, so the float32 values are exact)."""
    if obs.dim() not in (3, 4):
        raise ValueError(f"expected image obs, got ndim={obs.dim()}")
    x = as_i32(obs).to(torch.float32)
    return 0.25 * (
        x[:, ::2, ::2] + x[:, 1::2, ::2] + x[:, ::2, 1::2] + x[:, 1::2, 1::2]
    )
