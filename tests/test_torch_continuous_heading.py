"""Continuous headings of the port against the JAX package.

The port's contract: a continuous heading's direction is the correctly
rounded float32 cos/sin of the float32 angle (``render.cos_f32`` and
``sin_f32``: the float64 function, rounded), the same on the CPU and on the
card.  The JAX package uses XLA's float32 cos/sin, which differ from the
correctly rounded value by 1 ulp on about 1.3% of headings.  So:

* ``sampling.sample_heading`` is bit-exact with the JAX sampler;
* ``cos_f32``/``sin_f32`` equal numpy's float64 cos/sin rounded to float32,
  and are within 1 ulp of XLA's (the count that differs is printed);
* ``raycast.ray_fan`` is exact against the JAX ``ray_fan`` run eagerly and
  against ``OracleContinuous.ray_fan`` given the same heading vectors (the
  jitted JAX fan contracts the lerp into FMAs; the count is printed);
* 160-step fixed-seed trajectories (seeds 0 and 6) are exact, positions,
  float headings, rewards, dones and frames every 16 steps, against a
  test-local ``OracleContinuous`` whose heading vector is correctly rounded;
* ``Env`` against the jitted JAX ``Env`` (SingleRoom, MultiPlayerRoom,
  Maze under ``crossing`` and ``scan``, ``depth``): headings exact after
  the reset and fractional turns; every state leaf, reward, done and info
  entry exact, and observations exact (or exact against the eager JAX
  observation where a jitted FMA moved a pixel; ``depth``, which the
  jitted fan's FMAs move, always exact against the eager JAX), on every env whose
  headings' XLA and correctly rounded cos/sin agreed so far.  The test
  asserts that this mask keeps most envs and prints how many it excludes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
from raycastworlds_tpu.oracle.families import OracleContinuous
from raycastworlds_tpu.ops import raycast as jraycast
from raycastworlds_tpu.ops import sampling as jsampling
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch.ops import raycast, render, sampling
from raycastworlds_tpu_torch.state import LEAVES, OPTIONAL_LEAVES

TWO_PI_OVER_128 = np.float32(2.0 * np.pi / 128)


def np_(x):
    return x.detach().cpu().numpy()


def angles(n, seed):
    """float32 angles of n uniform headings in [0, 128), as the step forms
    them: heading * float32(2 pi / 128)."""
    h = np.random.default_rng(seed).uniform(0, 128, size=n).astype(np.float32)
    return (h * TWO_PI_OVER_128).astype(np.float32)


_xla_cos_sin = jax.jit(lambda a: (jnp.cos(a), jnp.sin(a)))


def correctly_rounded(a):
    a = np.asarray(a, np.float64)
    return np.cos(a).astype(np.float32), np.sin(a).astype(np.float32)


# -- the pieces -------------------------------------------------------------


@pytest.mark.parametrize("d", [128, 7])
def test_sample_heading_bit_exact(d):
    n = 4096
    got = sampling.sample_heading(rt.rng.split(rt.rng.PRNGKey(0), n), d, True)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    want = np.asarray(jax.vmap(lambda k: jsampling.sample_heading(k, d, True))(keys))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(np_(got), want)
    assert want.min() >= 0 and want.max() < d and len(np.unique(want)) > n // 2
    np.testing.assert_array_equal(
        np_(sampling.sample_heading(rt.rng.split(rt.rng.PRNGKey(0), n), d)),
        np.asarray(jax.vmap(lambda k: jsampling.sample_heading(k, d))(keys)))


def test_cos_sin_f32_correctly_rounded():
    a = angles(400_000, 1)
    cos, sin = render.cos_f32(torch.from_numpy(a)), render.sin_f32(torch.from_numpy(a))
    assert cos.dtype == sin.dtype == torch.float32
    want_c, want_s = correctly_rounded(a)
    np.testing.assert_array_equal(np_(cos), want_c)
    np.testing.assert_array_equal(np_(sin), want_s)
    xc, xs = (np.asarray(x) for x in _xla_cos_sin(a))
    for name, got, xla in (("cos", np_(cos), xc), ("sin", np_(sin), xs)):
        ulps = np.abs(got.view(np.int32).astype(np.int64) - xla.view(np.int32))
        assert ulps.max() <= 1, name
        print(f"XLA float32 {name} differs from the correctly rounded value on "
              f"{int((ulps > 0).sum())} of {len(a)} headings, by 1 ulp")
    # a float64 world takes torch's float64 cos/sin as they are
    f64 = a.astype(np.float64)
    np.testing.assert_array_max_ulp(np_(torch.cos(torch.from_numpy(f64))), np.cos(f64), 1)


@pytest.mark.parametrize("r", [48, 33])
def test_ray_fan_matches_eager_jax_and_oracle(r):
    cfg = rt.EnvConfig(num_rays=r, continuous_heading=True)
    jcfg = rcw.EnvConfig(num_rays=r, continuous_heading=True)
    c, s = correctly_rounded(angles(64, 2))
    d = np.stack([c, s], -1)
    got = np_(raycast.ray_fan(cfg, torch.from_numpy(d)))
    assert got.shape == (64, r, 2) and got.dtype == np.float32
    with jax.disable_jit():
        eager = np.asarray(jax.vmap(lambda v: jraycast.ray_fan(jcfg, v))(d))
    np.testing.assert_array_equal(got, eager)
    oracle = OracleContinuous(jcfg)
    for e in range(len(d)):
        oracle.player_dir = lambda e=e: d[e]
        np.testing.assert_array_equal(got[e], oracle.ray_fan())
    jitted = np.asarray(jax.jit(jax.vmap(lambda v: jraycast.ray_fan(jcfg, v)))(d))
    print(f"R={r}: jitted JAX ray_fan differs on {int((jitted != got).sum())} of "
          f"{got.size} components")
    # the port's float64 fan is the LUT formula in float64
    c64 = rt.EnvConfig(num_rays=r, dtype="float64")
    d64 = torch.from_numpy(c64.directions_wu[:9])
    np.testing.assert_allclose(np_(raycast.ray_fan(c64, d64)), c64.ray_fan_lut[:9],
                               rtol=0, atol=4e-16)


# -- trajectories against the correctly rounded oracle -----------------------


class CorrectlyRoundedOracle(OracleContinuous):
    """OracleContinuous with the port's heading contract: the float64
    cos/sin of the float32 angle, rounded to float32."""

    def player_dir(self):
        ang = np.float32(self.dir_au) * np.float32(2.0 * np.pi / self.cfg.num_directions)
        return np.stack(correctly_rounded(ang)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 6])
def test_trajectory_matches_correctly_rounded_oracle(seed):
    kw = dict(num_rays=48, height_camera_view_pu=32, continuous_heading=True,
              turn_increment_au=0.7)
    game = rt.SingleRoom(rt.EnvConfig(**kw))
    oracle = CorrectlyRoundedOracle(rcw.EnvConfig(**kw))
    state = game.reset_batch(rt.rng.PRNGKey(seed)[None])
    oracle.reset(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    resets = 0
    for t in range(160):
        assert np_(state.pos_wu)[0].tolist() == oracle.pos_wu.tolist(), t
        assert np_(state.dir_au)[0] == oracle.dir_au, t
        assert float(state.reward[0]) == float(oracle.reward), t
        assert bool(state.done[0]) == oracle.done, t
        if t % 16 == 0:
            frame = np_(game.observe_batch(state)[0].view(torch.int32)).view(np.uint32)
            np.testing.assert_array_equal(frame, oracle.camera_view(), err_msg=f"step {t}")
        if bool(state.done[0]):
            key = np_(state.rng_key)[0].astype(np.uint32)
            state = game.reset_batch(state.rng_key)
            oracle.reset(jnp.asarray(key))
            resets += 1
        else:
            a = int(rng.choice(4, p=[0.55, 0.05, 0.2, 0.2]))
            state = game.step_batch(state, torch.tensor([a], dtype=torch.int32))
            oracle.step(a)
    assert np_(state.dir_au)[0] != np.round(np_(state.dir_au)[0])
    print(f"seed {seed}: 160 steps, {resets} goal resets, exact")


# -- Env against the JAX package on the envs the cos/sin mask keeps ------------


def jax_leaves(state):
    out = {k: np.asarray(getattr(state, k)) for k in LEAVES}
    for k in OPTIONAL_LEAVES:
        if getattr(state, k) is not None:
            out[k] = np.asarray(getattr(state, k))
    return out


def agree(dir_au):
    """bool[B]: every heading of the env (a player axis folded in) has the
    same XLA and correctly rounded cos and sin."""
    d = np.asarray(dir_au, np.float32)
    a = (d * TWO_PI_OVER_128).astype(np.float32)
    xc, xs = (np.asarray(x) for x in _xla_cos_sin(a))
    c, s = correctly_rounded(a)
    same = (xc == c) & (xs == s)
    return same.reshape(len(d), -1).all(axis=1)


def run_masked(jenv, env, steps, seed=3, scripted=True):
    """Reset and ``steps`` numpy-seeded steps of both envs; compares every
    leaf, reward, done, info entry and observation on the envs still clean
    (``agree`` at every heading so far).  Returns the clean mask."""
    b = env.num_envs
    p = env.game.action_shape
    depth = env.cfg.obs_type == "depth"
    js, jobs = jenv.reset(jax.random.PRNGKey(seed))
    ts, tobs = env.reset(rt.rng.PRNGKey(seed))
    np.testing.assert_array_equal(np_(ts.dir_au), np.asarray(js.dir_au))
    assert ts.dir_au.dtype == torch.float32
    if scripted:  # envs 0-1 0.3 above the goal facing it (heading 0 is clean)
        pos, dir_au = np.asarray(js.pos_wu).copy(), np.asarray(js.dir_au).copy()
        pos[:2] = np.asarray(js.goal_tu)[:2] + np.float32([-0.3, 0.5])
        dir_au[:2] = 0.0
        js = js.replace(pos_wu=jnp.asarray(pos), dir_au=jnp.asarray(dir_au))
        ts = rt.EnvState.from_numpy({**jax_leaves(js), "hw": js.hw})
        jobs, tobs = jenv.game.observe_batch(js), env.game.observe_batch(ts)
    clean = agree(js.dir_au)
    moved, eager_states, eager_frames = 0, [], []

    def obs_check(jstate, got, want):
        nonlocal moved
        keep = np.flatnonzero(clean)
        g, w = got[keep], want[keep]
        moved += int((g != w).sum())
        if depth:
            # the jitted fan's FMAs move the rays, so depth moves by more
            # than the 4 ulp of the discrete headings: every kept depth
            # frame is held exactly against eager JAX
            envs = keep
        else:
            envs = keep[(g != w).reshape(len(g), -1).any(1)]
        if len(envs):
            eager_states.append(jax.tree_util.tree_map(lambda x: np.asarray(x)[envs], jstate))
            eager_frames.append(got[envs])

    obs_check(js, np_(tobs), np.asarray(jobs))
    actions = np.random.default_rng(seed).choice(
        4, size=(steps, b) + p, p=[0.5, 0.05, 0.25, 0.2]).astype(np.int32)
    actions[:3, :2] = 0
    paid = 0
    for a in actions:
        jr = jenv.step(js, jnp.asarray(a))
        tr = env.step(ts, torch.from_numpy(a))
        w, g = jax_leaves(jr.state), tr.state.to_numpy()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k][clean], w[k][clean], err_msg=k)
        for got, want in ((tr.reward, jr.reward), (tr.done, jr.done),
                          *((tr.info[k], jr.info[k]) for k in jr.info)):
            np.testing.assert_array_equal(np_(got)[clean], np.asarray(want)[clean])
        paid += int((np.asarray(jr.reward)[clean] > 0).sum())
        clean = clean & agree(jr.state.dir_au)
        obs_check(jr.state, np_(tr.obs), np.asarray(jr.obs))
        js, ts = jr.state, tr.state
    if eager_states:
        sub = jax.tree_util.tree_map(lambda *xs: np.concatenate(xs), *eager_states)
        with jax.disable_jit():
            eager = np.asarray(jenv.game.observe_batch(sub))
        np.testing.assert_array_equal(np.concatenate(eager_frames), eager)
    d = np_(ts.dir_au)
    assert np.any(np.abs(d - np.round(d)) > 1e-3)  # fractional headings
    assert clean.mean() >= 0.5, f"the mask keeps {clean.sum()} of {b} envs"
    print(f"{env.game.__class__.__name__} {env.cfg.obs_type} "
          f"{env.cfg.raycast_backend}: the cos/sin mask excludes {b - clean.sum()} of {b} "
          f"envs; {moved} observation values differ from jitted JAX on the kept envs, "
          f"all equal to eager JAX; {paid} goal rewards on kept envs")
    return clean, paid


SMALL = dict(num_rays=32, height_camera_view_pu=24, continuous_heading=True,
             turn_increment_au=0.7, max_episode_steps=12)


@pytest.mark.parametrize("obs_type", ["camera_u32", "depth"])
def test_single_room_env_matches_jax_on_masked_envs(obs_type):
    kw = dict(SMALL, obs_type=obs_type)
    jenv = rcw.Env(rcw.SingleRoom(rcw.EnvConfig(**kw)), num_envs=16)
    env = rt.Env(rt.SingleRoom(rt.EnvConfig(**kw)), num_envs=16, device="cpu")
    clean, paid = run_masked(jenv, env, 40)
    assert paid > 0
    if obs_type == "depth":
        s, obs = env.reset(rt.rng.PRNGKey(0))
        assert obs.dtype == torch.float32 and bool((obs > 0).all())
        assert env.observation_space.dtype == torch.float32


def test_multi_player_env_matches_jax_on_masked_envs():
    kw = dict(SMALL, num_players=2, obs_type="camera_pal8", wall_texture="brick")
    jenv = rcw.Env(rcw.MultiPlayerRoom(rcw.MultiPlayerConfig(**kw)), num_envs=12)
    env = rt.Env(rt.MultiPlayerRoom(rt.MultiPlayerConfig(**kw)), num_envs=12, device="cpu")
    run_masked(jenv, env, 24, seed=4, scripted=False)


@pytest.mark.parametrize("backend", ["crossing", "scan"])
def test_maze_env_matches_jax_on_masked_envs(backend):
    kw = dict(SMALL, raycast_backend=backend, height_tile_map_tu=9, width_tile_map_tu=9)
    jenv = rcw.Env(rcw.Maze(rcw.MazeConfig(**kw)), num_envs=8)
    env = rt.Env(rt.Maze(rt.MazeConfig(**kw)), num_envs=8, device="cpu")
    run_masked(jenv, env, 16, seed=1, scripted=False)
    obs = np_(env.reset(rt.rng.PRNGKey(1))[1].view(torch.int32)).view(np.uint32)
    present = set(np.unique(obs).tolist())
    assert {rt.colors.CEILING, rt.colors.FLOOR} <= present
    assert present & {rt.colors.WALL_DIM_I, rt.colors.WALL_DIM_J}
