"""MultiPlayerRoom of the port against the JAX package.

The sprite helpers (``ray_circle_t``, ``sprite_overlay``) on numpy-seeded
inputs, bit for bit against the JAX functions run eagerly; jitted, XLA on
the CPU contracts their mul+adds into FMAs, and the count of values that
moves is reported.

``Env(MultiPlayerRoom)`` against the jitted JAX ``Env``: reset and 30
numpy-seeded steps on 8 envs at 24 rays x 24 px, over 2 and 3 players, the
sprite, block and invisible modes, player collision on and off, camera_u32,
camera_pal8, depth, tile_grid and top_u32, dense and budgeted reset, and the
backends ``scan``, ``crossing``, ``crossing_kernel`` and ``pallas`` (their
plain versions on the CPU).  State leaves, rewards, dones and info entries
are exact at every step.  Observations are exact, or, for the envs where a
jitted-JAX value differs (the FMA of a sprite edge, of the crossing cast's
cross coordinate at a tile corner, of the top view's endpoint), exact
against the same JAX code run eagerly, which rounds every product and sum
on its own as the port does, and camera frames also exact against
``OracleMultiPlayer.camera_views()``; ``depth`` is within 4 ulp there
except on the rays a sprite's FMA moved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu.oracle.families import OracleMultiPlayer
from raycastworlds_tpu.ops import render as jrender
from raycastworlds_tpu.ops.raycast import RayHits as JaxRayHits
from raycastworlds_tpu_torch import colors
from raycastworlds_tpu_torch.ops import raycast_crossing_kernel as rck
from raycastworlds_tpu_torch.ops import raycast_pallas, render
from raycastworlds_tpu_torch.ops.raycast import RayHits
from raycastworlds_tpu_torch.state import LEAVES

B = 8
STEPS = 30
R2 = np.float32(0.125 ** 2)


def np_(x):
    return x.detach().cpu().numpy()


def jax_leaves(state):
    return {k: np.asarray(getattr(state, k)) for k in LEAVES}


def assert_state_equal(got: rt.EnvState, want):
    g, w = got.to_numpy(), jax_leaves(want)
    for k in LEAVES:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# -- the sprite helpers -----------------------------------------------------


def sprite_inputs(seed=0, b=64, r=64, k=3):
    """Positions, circles near them (some disabled) and rays aimed at the
    circles with a jitter, so that most rays hit one."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([1, 1], [7, 15], size=(b, 2)).astype(np.float32)
    centers = (pos[:, None, :] + rng.uniform(-3, 3, size=(b, k, 2))).astype(np.float32)
    mask = rng.random((b, k)) < 0.8
    aim = centers[np.arange(b)[:, None], rng.integers(0, k, size=(b, r))] - pos[:, None, :]
    ang = np.arctan2(aim[..., 1], aim[..., 0]) + rng.normal(0, 0.08, size=(b, r))
    dirs = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    return pos, dirs, centers, mask


def jax_ray_circle_t(pos, dirs, centers, mask):
    return jax.vmap(lambda p, d, c, m: jrender.ray_circle_t(p, d, c, m, R2))(
        pos, dirs, centers, mask)


def test_ray_circle_t_matches_eager_jax():
    pos, dirs, centers, mask = sprite_inputs()
    got = np_(render.ray_circle_t(*(torch.from_numpy(x) for x in (pos, dirs, centers, mask)), R2))
    with jax.disable_jit():
        eager = np.asarray(jax_ray_circle_t(pos, dirs, centers, mask))
    np.testing.assert_array_equal(got, eager)
    hit = np.isfinite(got)
    assert hit.sum() > 1000
    jitted = np.asarray(jax.jit(jax_ray_circle_t)(pos, dirs, centers, mask))
    moved = jitted != got
    print(f"jitted JAX ray_circle_t differs on {moved.sum()} of {hit.sum()} hits")
    # the FMA moves hits only, by far less than a pixel's worth of distance
    assert not (moved & ~hit).any()
    np.testing.assert_allclose(jitted[hit], got[hit], rtol=1e-4)


@pytest.mark.parametrize("pal8", [False, True], ids=["u32", "pal8"])
def test_sprite_overlay_matches_eager_jax(pal8):
    cfg = rt.EnvConfig(num_rays=64, height_camera_view_pu=48)
    pos, dirs, centers, mask = sprite_inputs(1)
    rng = np.random.default_rng(2)
    b, r = dirs.shape[:2]
    # walls beyond or before the sprites, player directions inside the fan
    dist = rng.uniform(0.5, 6.0, size=(b, r)).astype(np.float32)
    pdir = dirs[:, r // 2] + rng.normal(0, 0.05, size=(b, 2)).astype(np.float32)
    pdir = (pdir / np.linalg.norm(pdir, axis=-1, keepdims=True)).astype(np.float32)
    if pal8:
        img = rng.integers(0, 12, size=(b, 48, r)).astype(np.uint8)
        color = colors.PAL_BLOCK
    else:
        img = rng.integers(0, 1 << 24, size=(b, 48, r)).astype(np.uint32)
        color = colors.TILE_BLOCK
    t_s = np_(render.ray_circle_t(*(torch.from_numpy(x) for x in (pos, dirs, centers, mask)), R2))
    hits = RayHits(ray_dirs=torch.from_numpy(dirs), hit_tu=None, hit_dim=None,
                                  dist_wu=torch.from_numpy(dist))
    timg = torch.from_numpy(img if pal8 else img.view(np.int32))
    got = np_(render.sprite_overlay(cfg, timg, torch.from_numpy(pdir), hits,
                                    torch.from_numpy(t_s), color, 0.5))
    if not pal8:
        got = got.view(np.uint32)
    jcfg = rcw.EnvConfig(num_rays=64, height_camera_view_pu=48)
    jcolor = (jnp.uint8 if pal8 else jnp.uint32)(color)

    def one(im, pd, rd, d, t):
        h = JaxRayHits(ray_dirs=rd, hit_tu=None, hit_dim=None, dist_wu=d)
        return jrender.sprite_overlay(jcfg, im, pd, h, t, jcolor, 0.5)

    with jax.disable_jit():
        eager = np.asarray(jax.vmap(one)(img, pdir, dirs, dist, t_s))
    np.testing.assert_array_equal(got, eager)
    assert (got == color).sum() > 1000 and (got != img).any()


# -- Env(MultiPlayerRoom) against the JAX package ---------------------------

CASES = {
    "sprite_u32_2p_crossing": dict(),
    "sprite_pal8_3p_crossing_kernel": dict(num_players=3, obs_type="camera_pal8",
                                           raycast_backend="crossing_kernel"),
    "block_u32_3p_pallas": dict(num_players=3, player_render="block",
                                raycast_backend="pallas"),
    "invisible_u32_2p_no_collision": dict(players_visible=False, player_collision=False),
    "sprite_depth_2p_scan": dict(obs_type="depth", raycast_backend="scan"),
    "block_tile_grid_3p": dict(num_players=3, player_render="block", obs_type="tile_grid"),
    "sprite_top_u32_2p_scan": dict(obs_type="top_u32", pu_per_tu=8, raycast_backend="scan"),
    "sprite_u32_2p_budget_scan": dict(raycast_backend="scan", budget=2),
    "block_pal8_3p_budget_scan": dict(num_players=3, player_render="block",
                                      obs_type="camera_pal8", raycast_backend="scan",
                                      budget=2),
}


def make_envs(kw, num_envs=B):
    kw = dict(kw)
    budget = kw.pop("budget", 0)
    ckw = dict(dict(num_rays=24, height_camera_view_pu=24, max_episode_steps=9), **kw)
    jenv = rcw.Env(rcw.MultiPlayerRoom(rcw.MultiPlayerConfig(**ckw)), num_envs=num_envs,
                   reset_budget=budget)
    env = rt.Env(rt.MultiPlayerRoom(rt.MultiPlayerConfig(**ckw)), num_envs=num_envs,
                 reset_budget=budget, device="cpu")
    return jenv, env


def scripted_start(js):
    """Envs 0-3: player 0 placed 0.3 above the goal tile facing it, player 1
    half a tile ahead of it on the same row, facing it; the rest as reset."""
    pos = np.asarray(js.pos_wu).copy()
    dir_au = np.asarray(js.dir_au).copy()
    goal = np.asarray(js.goal_tu)
    pos[:4, 0] = goal[:4] + np.array([-0.3, 0.5], np.float32)
    dir_au[:4, 0] = 0
    pos[4:6, 0] = np.array([2.5, 2.3], np.float32)
    pos[4:6, 1] = np.array([2.5, 2.7], np.float32)
    dir_au[4:6, :2] = [32, 96]  # +j and -j of 128 headings: converging
    js = js.replace(pos_wu=jnp.asarray(pos), dir_au=jnp.asarray(dir_au))
    return js, rt.EnvState.from_numpy({**jax_leaves(js), "hw": js.hw})


def oracle_views(cfg, state, e):
    o = OracleMultiPlayer(cfg)
    o.wall_map = np.asarray(cfg.border_wall_map)
    o.goal_tu = tuple(int(x) for x in np.asarray(state.goal_tu[e]))
    o.ppos = np.asarray(state.pos_wu[e]).copy()
    o.pdir = [int(x) for x in np.asarray(state.dir_au[e])]
    return o.camera_views()


class ObsCheck:
    """Observations against the jitted JAX ones: exact (``depth`` within 4
    ulp), or, on the envs where they differ, exact against the oracle's
    camera views at once and against the eager JAX observation in one call
    at the end (:meth:`explain`); ``moved`` counts the values that differ
    from the jitted JAX observation."""

    def __init__(self, jenv):
        self.jenv, self.cfg = jenv, jenv.cfg
        self.states, self.frames = [], []
        self.moved = 0

    def __call__(self, jstate, got, want):
        cfg = self.cfg
        assert got.shape == want.shape and got.dtype == want.dtype
        if cfg.obs_type == "depth":
            close = np.abs(got - want) <= 4 * np.spacing(np.abs(want))
            bad = ~close.reshape(len(got), -1).all(axis=1)
        else:
            bad = (got != want).reshape(len(got), -1).any(axis=1)
        if not bad.any():
            return
        assert cfg.obs_type != "tile_grid"  # no float reaches a tile grid
        envs = np.flatnonzero(bad)
        self.states.append(jax.tree_util.tree_map(lambda x: np.asarray(x)[envs], jstate))
        self.frames.append(got[envs])
        self.moved += int((got != want).sum())
        if cfg.obs_type in ("camera_u32", "camera_pal8"):
            for e in envs:
                frames = got[e] if cfg.obs_type == "camera_u32" else colors.PALETTE_NP[got[e]]
                np.testing.assert_array_equal(frames, oracle_views(cfg, jstate, e))

    def explain(self):
        if not self.states:
            return
        sub = jax.tree_util.tree_map(lambda *xs: np.concatenate(xs), *self.states)
        with jax.disable_jit():
            eager = np.asarray(self.jenv.game.observe_batch(sub))
        np.testing.assert_array_equal(np.concatenate(self.frames), eager)


@pytest.mark.parametrize("name", list(CASES))
def test_multi_player_env_matches_jax(name):
    jenv, env = make_envs(CASES[name])
    check = ObsCheck(jenv)
    p = env.cfg.num_players
    js, jobs = jenv.reset(jax.random.PRNGKey(5))
    ts, tobs = env.reset(rt.rng.PRNGKey(5))
    assert_state_equal(ts, js)
    assert tobs.shape == (B,) + env.cfg.obs_shape and env.action_space.shape == (p,)
    check(js, np_(tobs), np.asarray(jobs))
    js, ts = scripted_start(js)
    actions = np.random.default_rng(1).choice(
        4, size=(STEPS, B, p), p=[0.55, 0.05, 0.2, 0.2]).astype(np.int32)
    actions[:4, :6, :2] = 0
    n_paid = n_trunc = n_frozen = 0
    for a in actions:
        jr = jenv.step(js, jnp.asarray(a))
        tr = env.step(ts, torch.from_numpy(a))
        assert_state_equal(tr.state, jr.state)
        np.testing.assert_array_equal(np_(tr.reward), np.asarray(jr.reward))
        np.testing.assert_array_equal(np_(tr.done), np.asarray(jr.done))
        assert sorted(tr.info) == sorted(jr.info)
        for k in jr.info:
            np.testing.assert_array_equal(np_(tr.info[k]), np.asarray(jr.info[k]), err_msg=k)
        check(jr.state, np_(tr.obs), np.asarray(jr.obs))
        n_paid += int((np.asarray(jr.reward) > 0).sum())
        n_trunc += int(np.asarray(jr.info["truncated"]).sum())
        n_frozen += int(np.asarray(jr.state.pending_reset).sum())
        js, ts = jr.state, tr.state
    check.explain()
    print(f"{name}: {check.moved} observation values differ from jitted JAX, "
          f"in {sum(len(f) for f in check.frames)} env frames, all explained")
    assert n_paid > 0 and n_trunc > 0
    assert (n_frozen > 0) == (env.reset_budget > 0)


def test_player_collision_matches_jax():
    """Converging candidates (the lower index moves) and a march into the
    other player (blocked before overlap), as in tests/test_multi_player.py,
    through the port's step against the JAX step."""
    kw = dict(num_players=2, num_rays=16, height_camera_view_pu=16)
    jg = rcw.MultiPlayerRoom(rcw.MultiPlayerConfig(**kw))
    g = rt.MultiPlayerRoom(rt.MultiPlayerConfig(**kw))
    js = jax.vmap(jg.reset_single)(jax.random.split(jax.random.PRNGKey(7), 2))
    js = js.replace(
        pos_wu=jnp.asarray([[[2.5, 2.3], [2.5, 2.7]], [[2.5, 2.5], [2.5, 4.5]]], jnp.float32),
        dir_au=jnp.asarray([[32, 96], [32, 96]], jnp.int32),
        goal_tu=jnp.asarray([[5, 10], [5, 10]], jnp.int32),
    )
    ts = rt.EnvState.from_numpy({**jax_leaves(js), "hw": js.hw})
    step = jax.jit(jax.vmap(jg.step_single))
    a = np.array([[0, 0], [0, 2]], np.int32)
    for _ in range(12):
        js = step(js, jnp.asarray(a))
        ts = g.step_batch(ts, torch.from_numpy(a))
        assert_state_equal(ts, js)
    pos = np_(ts.pos_wu)
    np.testing.assert_allclose(pos[0, 1], [2.5, 2.7])  # blocked every step
    assert np.linalg.norm(pos[1, 0] - pos[1, 1]) >= 0.25 - 1e-6


def test_frozen_reward_mask_keeps_player_axis():
    """Under a reset budget, envs awaiting their reset report reward 0 for
    every player: the frozen mask [B] broadcasts over rewards [B, P]."""
    _, env = make_envs(dict(max_episode_steps=1, budget=1), num_envs=4)
    ts, _ = env.reset(rt.rng.PRNGKey(0))
    a = torch.zeros((4, 2), dtype=torch.int32)
    ts = env.step(ts, a).state          # every env ends, one resets
    assert int(ts.pending_reset.sum()) == 3
    frozen = ts.pending_reset
    ts = ts.replace(reward=torch.ones(4, 2))
    res = env.step(ts, a)
    assert res.reward.shape == (4, 2)
    assert bool((res.reward[frozen] == 0).all())
    assert not bool(res.done[frozen].any())


@pytest.mark.parametrize("backend,obs_type,wrapper", [
    ("crossing_kernel", "camera_u32", "crossing"),
    ("auto", "depth", None),
    ("crossing_kernel_fused", "camera_pal8", "crossing"),
    ("crossing_kernel_fused", "camera_rgb", "crossing"),
    ("pallas", "camera_u32", "dda"),
])
def test_one_cast_per_observation(monkeypatch, backend, obs_type, wrapper):
    """One call of the cast kernel's wrapper per observation, at [B*P, R],
    for every player of every env; never the fused render kernels."""
    calls = {"crossing": [], "dda": [], "fused": []}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            calls[name].append(tuple(args[3].shape))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(rck, "cast_rays_crossing_kernel",
                        counted("crossing", rck.cast_rays_crossing_kernel))
    monkeypatch.setattr(raycast_pallas, "cast_rays_pallas_batched",
                        counted("dda", raycast_pallas.cast_rays_pallas_batched))
    monkeypatch.setattr(rck, "cast_render_pal8_kernel",
                        counted("fused", rck.cast_render_pal8_kernel))
    _, env = make_envs(dict(num_players=3, raycast_backend=backend, obs_type=obs_type),
                       num_envs=4)
    ts, _ = env.reset(rt.rng.PRNGKey(1))
    env.step(ts, torch.zeros((4, 3), dtype=torch.int32))
    want = {name: [(12, 24, 2)] * 2 if name == wrapper else [] for name in calls}
    assert calls == want


def test_config_and_ported_features():
    with pytest.raises(ValueError, match="num_players"):
        rt.MultiPlayerConfig(num_players=0)
    with pytest.raises(ValueError, match="player_render"):
        rt.MultiPlayerConfig(player_render="disc")
    with pytest.raises(ValueError, match="sprite_height_wu"):
        rt.MultiPlayerConfig(sprite_height_wu=0.0)
    with pytest.raises(TypeError):
        rt.MultiPlayerRoom(rt.EnvConfig())
    cont = rt.MultiPlayerRoom(rt.MultiPlayerConfig(continuous_heading=True, num_rays=8,
                                                   height_camera_view_pu=8))
    cs = cont.reset_batch(rt.rng.split(rt.rng.PRNGKey(0), 2))
    assert cs.dir_au.shape == (2, 2) and cs.dir_au.dtype == torch.float32
    assert cont.observe_batch(cs).shape == (2, 2, 8, 8)
    cfg = rt.MultiPlayerConfig(num_players=3, num_rays=16, height_camera_view_pu=8)
    assert cfg.obs_shape == rcw.MultiPlayerConfig(
        num_players=3, num_rays=16, height_camera_view_pu=8).obs_shape == (3, 8, 16)
