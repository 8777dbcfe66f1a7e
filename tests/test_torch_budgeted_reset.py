"""Budgeted auto-reset (``Env(reset_budget=K)``) against the JAX package,
bit for bit.

16 envs, 32 rays x 24 px, cast by the scan DDA (the JAX package's CPU
crossing cast contracts ``p + t*d`` into an FMA and can name another face
for a ray through a tile corner, which reset positions at tile centres
meet).  ``max_episode_steps=4`` makes every env end its
episode in the same step, far more than the budget resets, so envs freeze
with ``pending_reset`` set and are reset over the following steps; envs 0-5
start facing their goal so that terminations mix in.  Every state leaf
(``pending_reset`` included), the observation, the reward (0 while frozen),
done and every info entry are compared at every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch.state import LEAVES

B = 16
STEPS = 24
CFG = dict(num_rays=32, height_camera_view_pu=24, max_episode_steps=4,
           raycast_backend="scan")


def _leaves(state):
    return {k: np.asarray(getattr(state, k)) for k in LEAVES}


def _assert_state_equal(got, want):
    g, w = got.to_numpy(), _leaves(want)
    for k in LEAVES:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize(
    "family,budget",
    [("SingleRoom", 3), ("RandomRoom", 5), ("SingleRoom", 99)],
    ids=["single_room_3", "random_room_5", "budget_above_batch"],
)
def test_budgeted_reset_matches_jax(family, budget):
    if family == "RandomRoom":
        kw = dict(CFG, height_tile_map_tu=10, width_tile_map_tu=10)
        jgame, game = rcw.RandomRoom(rcw.RandomRoomConfig(**kw)), rt.RandomRoom(
            rt.RandomRoomConfig(**kw))
    else:
        jgame, game = rcw.SingleRoom(rcw.EnvConfig(**CFG)), rt.SingleRoom(
            rt.EnvConfig(**CFG))
    jenv = rcw.Env(jgame, num_envs=B, reset_budget=budget)
    env = rt.Env(game, num_envs=B, reset_budget=budget, device="cpu")
    assert env.reset_budget == jenv.reset_budget == min(budget, B)

    js, _ = jenv.reset(jax.random.PRNGKey(4))
    pos = np.asarray(js.pos_wu).copy()
    pos[:6] = np.asarray(js.goal_tu)[:6] + np.array([-0.3, 0.5], np.float32)
    dir_au = np.asarray(js.dir_au).copy()
    dir_au[:6] = 0
    js = js.replace(pos_wu=jnp.asarray(pos), dir_au=jnp.asarray(dir_au))
    ts = rt.EnvState.from_numpy({**_leaves(js), "hw": js.hw})

    actions = np.random.default_rng(2).choice(
        4, size=(STEPS, B), p=[0.55, 0.05, 0.2, 0.2]).astype(np.int32)
    actions[:3, :6] = 0
    max_pending = n_term = 0
    frozen_seen = False
    for a in actions:
        was_pending = np.asarray(js.pending_reset)
        jr = jenv.step(js, jnp.asarray(a))
        tr = env.step(ts, torch.from_numpy(a))
        _assert_state_equal(tr.state, jr.state)
        np.testing.assert_array_equal(tr.obs.numpy(), np.asarray(jr.obs))
        np.testing.assert_array_equal(tr.reward.numpy(), np.asarray(jr.reward))
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        for k in jr.info:
            np.testing.assert_array_equal(tr.info[k].numpy(), np.asarray(jr.info[k]),
                                          err_msg=k)
        if was_pending.any():
            frozen_seen = True
            assert not tr.done.numpy()[was_pending].any()
            assert (tr.reward.numpy()[was_pending] == 0).all()
        max_pending = max(max_pending, int(tr.state.pending_reset.sum()))
        n_term += int(np.asarray(jr.info["terminated"]).sum())
        js, ts = jr.state, tr.state
    assert n_term > 0
    if budget < B:
        assert frozen_seen and max_pending >= B - budget - 6
    else:
        assert max_pending == 0
