"""The state helpers -- ``EnvState.wall_map``, ``replace_walls``,
``batch_shape`` and the module functions ``tile_map`` and ``metrics`` --
against the JAX package's, exact, on the JAX states of SingleRoom,
MultiGoalRoom (goal words) and DynamicRoom after a reset and a few steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu import state as jstate
from raycastworlds_tpu_torch import state as tstate
from raycastworlds_tpu_torch.state import LEAVES, OPTIONAL_LEAVES

B = 8
SMALL = dict(num_rays=16, height_camera_view_pu=16)
GAMES = {
    "single_room": (rcw.SingleRoom, rcw.EnvConfig, {}),
    "multi_goal": (rcw.MultiGoalRoom, rcw.MultiGoalConfig, dict(num_goals=4)),
    "dynamic_room": (rcw.DynamicRoom, rcw.DynamicRoomConfig, {}),
}


def _states(name):
    """The JAX state after a reset and 3 random steps, and the port's state
    built from its leaves."""
    game, config, kw = GAMES[name]
    jenv = rcw.Env(game(config(**SMALL, **kw)), num_envs=B)
    js, _ = jenv.reset(jax.random.PRNGKey(5))
    acts = np.random.default_rng(5).integers(0, 4, size=(3, B)).astype(np.int32)
    for a in acts:
        js = jenv.step(js, jnp.asarray(a)).state
    leaves = {k: np.asarray(getattr(js, k)) for k in LEAVES + OPTIONAL_LEAVES
              if getattr(js, k, None) is not None}
    leaves["hw"] = js.hw
    return js, rt.EnvState.from_numpy(leaves)


@pytest.mark.parametrize("name", sorted(GAMES))
def test_state_helpers_match_jax(name):
    js, ts = _states(name)
    assert ts.batch_shape == tuple(js.batch_shape) == (B,)
    np.testing.assert_array_equal(ts.wall_map.numpy(), np.asarray(js.wall_map))
    got, want = tstate.tile_map(ts).numpy(), np.asarray(jstate.tile_map(js))
    assert got.shape == want.shape == (B, 2) + js.hw and got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert rt.tile_map is tstate.tile_map
    tm, jm = tstate.metrics(ts), jstate.metrics(js)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), err_msg=k)

    # a new dense wall map re-packs to the JAX package's words
    flip = np.random.default_rng(1).random((B,) + js.hw) < 0.2
    walls = np.asarray(js.wall_map) ^ flip
    got = ts.replace_walls(torch.from_numpy(walls)).to_numpy()["wall_words"]
    want = np.asarray(js.replace_walls(jnp.asarray(walls)).wall_words)
    np.testing.assert_array_equal(got, want)
