"""Rollout drivers: Python loops over ``Env.step``, with actions drawn from
threefry keys exactly as the JAX package's scanned rollouts draw them.

Under an ``Env(mesh=...)`` each rank draws and steps its own rows of the
global batch (``Env.shard``), and the throughput program's checksum is
summed over the dp ranks, so every rank returns the global value.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import rng
from ..env import Env
from ..state import EnvState
from .mesh import DATA_AXIS


class Trajectory(NamedTuple):
    """Time-major [T, B, ...] rollout record."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    log_prob: Optional[torch.Tensor] = None
    value: Optional[torch.Tensor] = None


def rollout_random(
    env: Env, state: EnvState, key: torch.Tensor, num_steps: int
) -> tuple[EnvState, Trajectory]:
    """T uniform-random steps; returns (final_state, trajectory)."""
    key = key.to(env.device)
    shape = (env.num_envs,) + env.game.action_shape
    obs, actions, rewards, dones = [], [], [], []
    for _ in range(num_steps):
        key, k_act = rng.split(key).unbind(0)
        a = rng.randint(k_act, shape, 0, env.game.num_actions, env.shard)
        res = env.step(state, a)
        state = res.state
        obs.append(res.obs)
        actions.append(a)
        rewards.append(res.reward)
        dones.append(res.done)
    return state, Trajectory(
        obs=torch.stack(obs), action=torch.stack(actions),
        reward=torch.stack(rewards), done=torch.stack(dones),
    )


def rollout_policy(
    env: Env,
    policy_fn: Callable[[torch.Tensor, torch.Tensor], tuple],
    state: EnvState,
    key: torch.Tensor,
    num_steps: int,
) -> tuple[EnvState, Trajectory]:
    """T policy steps.  ``policy_fn(obs, key) -> (action, log_prob, value)``
    (already closed over the params).  The first observation is made from
    ``state``; each step splits the key as the JAX rollout does and records
    the observation the action was chosen on."""
    key = key.to(env.device)
    obs = env.game.observe_batch(state)
    recs = []
    for _ in range(num_steps):
        key, k_act = rng.split(key).unbind(0)
        action, log_prob, value = policy_fn(obs, k_act)
        res = env.step(state, action)
        recs.append((obs, action, res.reward, res.done, log_prob, value))
        state, obs = res.state, res.obs
    return state, Trajectory(*(torch.stack(x) for x in zip(*recs)))


def steps_per_second_program(env: Env, num_steps: int):
    """Build the throughput program: ``run(state, key)`` takes ``num_steps``
    random steps and reduces every observation to one checksum on the
    device (float32, or float64 where the observations or rewards are
    float64), so the images are produced but never leave it.  Returns
    ``(final_state, checksum)``; the caller's host read of the checksum
    ends a timed region.  Under a mesh the checksum is all-reduced over dp
    (one collective at the end), in another order of summation than one
    process's."""

    def run(state: EnvState, key: torch.Tensor):
        # All T*B actions in one threefry draw, as the JAX program does.
        actions = rng.randint(
            key.to(env.device),
            (num_steps, env.num_envs) + env.game.action_shape,
            0, env.game.num_actions, env.shard, axis=1,
        )
        acc = torch.zeros((), dtype=torch.float32, device=env.device)
        for a in actions:
            res = env.step(state, a)
            obs = res.obs
            if obs.dtype == torch.uint32:
                # colours are < 2**24, so the int32 view converts exactly
                chk = (obs.view(torch.int32).to(torch.float32) * 2.0**-24).sum()
            elif obs.dtype == torch.float64:
                chk = obs.sum()
            else:
                chk = obs.to(torch.float32).sum()
            acc = acc + chk + res.reward.sum()
            state = res.state
        if env.mesh is not None:
            env.mesh.all_reduce(acc, DATA_AXIS)
        return state, acc

    return run
