"""The whole-world views of the port against the JAX package: the top view
(``ops/topview.py``, ``top_u32``/``top_rgb`` observations, ``Env.top_view``),
``Env.camera_view`` and the ``tile_grid`` observation, for every family.

Inputs are numpy-seeded; maps are the families' defaults or small ones, 16
rays, 8 px per tile.  Images are exact against the jitted JAX package, or,
on the envs where a jitted-JAX endpoint differs (XLA on the CPU contracts
``pos + dist*dir`` into an FMA, which can move the floor of a ray's end
pixel), exact against the same JAX code run eagerly.  The SingleRoom top
view also follows ``OracleSingleRoom.top_view`` along a trajectory, as
tests/test_topview.py does for the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu.oracle.single_room import OracleSingleRoom
from raycastworlds_tpu.ops import topview as jtopview
from raycastworlds_tpu_torch.ops import topview
from raycastworlds_tpu_torch.state import LEAVES, OPTIONAL_LEAVES

B = 4
SMALL = dict(num_rays=16, height_camera_view_pu=16, pu_per_tu=8)


def np_(x):
    return x.detach().cpu().numpy()


def to_port(js):
    leaves = {k: np.asarray(getattr(js, k)) for k in LEAVES + OPTIONAL_LEAVES
              if getattr(js, k) is not None}
    return rt.EnvState.from_numpy({**leaves, "hw": js.hw})


def assert_images(got, want, eager_fn, jstate):
    """``got`` == ``want``, or, on the envs where they differ, == the eager
    JAX ``eager_fn(jstate)`` of those envs."""
    assert got.shape == want.shape and got.dtype == want.dtype
    bad = (got != want).reshape(len(got), -1).any(axis=1)
    if bad.any():
        envs = np.flatnonzero(bad)
        sub = jax.tree_util.tree_map(lambda x: np.asarray(x)[envs], jstate)
        with jax.disable_jit():
            np.testing.assert_array_equal(got[envs], np.asarray(eager_fn(sub)))
    return int(bad.sum())


def test_bresenham_points_matches_jax():
    rng = np.random.default_rng(0)
    p0 = rng.integers(-5, 60, size=(64, 2)).astype(np.int32)
    p1 = rng.integers(-5, 60, size=(64, 2)).astype(np.int32)
    p1[:4] = p0[:4]  # single-point segments
    pts, valid = topview.bresenham_points(torch.from_numpy(p0), torch.from_numpy(p1), 80)
    jpts, jvalid = jtopview.bresenham_points(jnp.asarray(p0), jnp.asarray(p1), 80)
    np.testing.assert_array_equal(np_(valid), np.asarray(jvalid))
    np.testing.assert_array_equal(np_(pts)[np_(valid)], np.asarray(jpts)[np.asarray(jvalid)])
    # each segment has max(|dx|, |dy|) + 1 points and ends on its endpoint
    np.testing.assert_array_equal(np_(valid).sum(0), np.abs(p1 - p0).max(-1) + 1)


@pytest.mark.parametrize("extras", ["goal_tile", "goal_and_block_maps"])
def test_render_tile_blit_matches_jax(extras):
    cfg = rt.EnvConfig(height_tile_map_tu=7, width_tile_map_tu=9, pu_per_tu=6)
    jcfg = rcw.EnvConfig(height_tile_map_tu=7, width_tile_map_tu=9, pu_per_tu=6)
    rng = np.random.default_rng(1)
    walls = rng.random((8, 7, 9)) < 0.3
    goal = rng.integers(0, [7, 9], size=(8, 2)).astype(np.int32)
    maps = ([] if extras == "goal_tile"
            else list(rng.random((2, 8, 7, 9)) < 0.2))  # goal map, block map
    got = topview.render_tile_blit(cfg, *(torch.from_numpy(x) for x in [walls, goal] + maps))
    want = jax.vmap(lambda *x: jtopview.render_tile_blit(jcfg, *x))(walls, goal, *maps)
    np.testing.assert_array_equal(np_(got).view(np.uint32), np.asarray(want))


def test_top_view_follows_oracle_trajectory():
    """tests/test_topview.py's oracle trajectory, rendered by the port from
    the JAX states: 64 rays, 16 px per tile, every 8th of 40 steps."""
    kw = dict(num_rays=64, height_camera_view_pu=64, pu_per_tu=16)
    jg, g = rcw.SingleRoom(rcw.EnvConfig(**kw)), rt.SingleRoom(rt.EnvConfig(**kw))
    reset, step = jax.jit(jg.reset_single), jax.jit(jg.step_single)
    oracle = OracleSingleRoom(rcw.EnvConfig(**kw))
    key = jax.random.PRNGKey(11)
    state = reset(key)
    oracle.reset(key)
    rng = np.random.RandomState(4)
    for t in range(40):
        if t % 8 == 0:
            one = jax.tree_util.tree_map(lambda x: x[None], state)
            img = np_(g.top_view_batch(to_port(one)))[0]
            np.testing.assert_array_equal(img, oracle.top_view(), err_msg=f"step {t}")
        if bool(state.done):
            state = reset(state.rng_key)
            oracle.reset(state.rng_key)
        else:
            a = int(rng.choice(4, p=[0.5, 0.1, 0.2, 0.2]))
            state = step(state, jnp.int32(a))
            oracle.step(a)


FAMILIES = {
    "single_room": ("SingleRoom", "EnvConfig", {}),
    "random_room": ("RandomRoom", "RandomRoomConfig",
                    dict(height_tile_map_tu=10, width_tile_map_tu=10)),
    "maze": ("Maze", "MazeConfig", dict(height_tile_map_tu=9, width_tile_map_tu=9)),
    "multi_goal": ("MultiGoalRoom", "MultiGoalConfig", {}),
    "dynamic_room": ("DynamicRoom", "DynamicRoomConfig", dict(block_period=2)),
    "locked_room": ("LockedRoom", "LockedRoomConfig", {}),
    "multi_player": ("MultiPlayerRoom", "MultiPlayerConfig", dict(num_players=3)),
    "multi_player_block": ("MultiPlayerRoom", "MultiPlayerConfig",
                           dict(num_players=2, player_render="block")),
}


def make_envs(name, **kw):
    game, config, ckw = FAMILIES[name]
    ckw = {**SMALL, **ckw, **kw}
    jenv = rcw.Env(getattr(rcw, game)(getattr(rcw, config)(**ckw)), num_envs=B)
    env = rt.Env(getattr(rt, game)(getattr(rt, config)(**ckw)), num_envs=B, device="cpu")
    return jenv, env


def actions(env, n, seed):
    shape = (n, B) + env.game.action_shape
    return np.random.default_rng(seed).choice(
        4, size=shape, p=[0.55, 0.05, 0.2, 0.2]).astype(np.int32)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_top_views_and_camera_views_match_jax(name):
    """The top_u32 (or, for every other family, top_rgb) observation through
    reset and 6 steps, then Env.top_view and Env.camera_view of the last
    state, against the JAX package."""
    obs_type = "top_u32" if list(FAMILIES).index(name) % 2 == 0 else "top_rgb"
    jenv, env = make_envs(name, obs_type=obs_type)
    js, jobs = jenv.reset(jax.random.PRNGKey(2))
    ts, tobs = env.reset(rt.rng.PRNGKey(2))
    assert tobs.shape == (B,) + env.cfg.obs_shape
    assert tobs.dtype == env.observation_space.dtype
    obs_fn = jenv.game.observe_batch
    assert_images(np_(tobs), np.asarray(jobs), obs_fn, js)
    for a in actions(env, 6, 3):
        jr, tr = jenv.step(js, jnp.asarray(a)), env.step(ts, torch.from_numpy(a))
        assert_images(np_(tr.obs), np.asarray(jr.obs), obs_fn, jr.state)
        js, ts = jr.state, tr.state
    for fn, jfn, single in ((env.top_view, jenv.top_view, jenv.game.top_view_single),
                            (env.camera_view, jenv.camera_view, jenv.game.camera_view_single)):
        got = fn(ts)
        assert got.dtype == torch.uint32
        assert_images(np_(got), np.asarray(jfn(js)), jax.vmap(single), js)


@pytest.mark.parametrize("name", ["single_room", "multi_goal", "dynamic_room", "locked_room"])
def test_tile_grid_matches_jax(name):
    """tile_grid through reset and 12 steps: the goal tile, MultiGoalRoom's
    goal words as they are collected, DynamicRoom's moving blocks and
    LockedRoom's doors (3) until the key is held; exact."""
    jenv, env = make_envs(name, obs_type="tile_grid")
    js, jobs = jenv.reset(jax.random.PRNGKey(4))
    ts, tobs = env.reset(rt.rng.PRNGKey(4))
    np.testing.assert_array_equal(np_(tobs), np.asarray(jobs))
    # envs 0-1 start 0.3 above their target tile (the key in LockedRoom)
    target = np.asarray(js.key_tu if name == "locked_room" else js.goal_tu).copy()
    pos = np.asarray(js.pos_wu).copy()
    pos[:2] = target[:2] + np.array([-0.3, 0.5], np.float32)
    dir_au = np.asarray(js.dir_au).copy()
    dir_au[:2] = 0
    js = js.replace(pos_wu=jnp.asarray(pos), dir_au=jnp.asarray(dir_au))
    ts = to_port(js)
    acts = actions(env, 12, 5)
    acts[:3, :2] = 0
    for a in acts:
        jr, tr = jenv.step(js, jnp.asarray(a)), env.step(ts, torch.from_numpy(a))
        got = np_(tr.obs)
        assert got.dtype == np.int32 and got.shape == (B, env.cfg.H, env.cfg.W)
        np.testing.assert_array_equal(got, np.asarray(jr.obs))
        js, ts = jr.state, tr.state
    if name == "locked_room":
        assert np.asarray(js.key_held)[:2].any()
