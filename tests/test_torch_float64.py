"""Float64 worlds (``EnvConfig(dtype="float64")``) of the port against the
JAX package under ``jax.enable_x64()``, as tests/test_float64.py runs it.

* SingleRoom through ``Env`` against the jitted JAX ``Env``, 16 envs over 60
  numpy-seeded steps with goal terminations, truncations and auto-resets:
  every state leaf (float64 positions; float32 rewards at a reset, float64
  after a step, as in the JAX package), reward, done and info entry exact
  at every step; frames exact, or, on the envs where a jitted-JAX pixel
  differs, exact against the same JAX code run eagerly.  Cases: camera_u32
  under ``auto`` (the plain crossing cast), a textured camera_pal8 under an
  explicit ``crossing_kernel`` (a float64 world casts by the plain crossing
  in both packages) and ``scan``; and ``depth`` (float64), within 4 ulp of
  the jitted JAX and exact against the eager JAX.
* The float64 world against the float32 one of the same seed and actions,
  positions to 1e-5 over the first 10 steps (tests/test_float64.py).
* ``observation_space.dtype`` is float64 for ``depth``.
* The ``analytic`` cast in float64 against the JAX one: hit tiles and faces
  exact wherever the wall crossing lies more than 1e-9 from a grid line,
  distances to 1e-6 relative (the backend's stated tolerance); float64 out.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch.state import LEAVES

B = 16
STEPS = 60
SMALL = dict(num_rays=32, height_camera_view_pu=24, max_episode_steps=15, dtype="float64")


def np_(x):
    return x.detach().cpu().numpy()


def jax_leaves(state):
    return {k: np.asarray(getattr(state, k)) for k in LEAVES}


def assert_state_equal(got, want):
    g, w = got.to_numpy(), jax_leaves(want)
    for k in w:
        assert g[k].dtype == w[k].dtype, (k, g[k].dtype, w[k].dtype)
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


CASES = {
    "camera_u32_auto": dict(),
    "xor_pal8_crossing_kernel": dict(wall_texture="xor", obs_type="camera_pal8",
                                     raycast_backend="crossing_kernel"),
    "checker_u32_scan": dict(wall_texture="checker", raycast_backend="scan"),
    "depth_auto": dict(obs_type="depth"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_float64_env_matches_jax(name):
    kw = {**SMALL, **CASES[name]}
    depth = kw.get("obs_type") == "depth"
    with jax.enable_x64():
        jenv = rcw.Env(rcw.SingleRoom(rcw.EnvConfig(**kw)), num_envs=B)
        env = rt.Env(rt.SingleRoom(rt.EnvConfig(**kw)), num_envs=B, device="cpu")
        js, jobs = jenv.reset(jax.random.PRNGKey(2))
        ts, tobs = env.reset(rt.rng.PRNGKey(2))
        assert ts.pos_wu.dtype == torch.float64 and ts.reward.dtype == torch.float32
        assert_state_equal(ts, js)
        pos = np.asarray(js.pos_wu).copy()
        dir_au = np.asarray(js.dir_au).copy()
        pos[:4] = np.asarray(js.goal_tu)[:4] + np.array([-0.3, 0.5])
        dir_au[:4] = 0
        js = js.replace(pos_wu=jnp.asarray(pos), dir_au=jnp.asarray(dir_au))
        ts = rt.EnvState.from_numpy({**jax_leaves(js), "hw": js.hw})
        actions = np.random.default_rng(2).choice(
            4, size=(STEPS, B), p=[0.55, 0.05, 0.2, 0.2]).astype(np.int32)
        actions[:3, :4] = 0
        states, frames, moved, worst = [], [], 0, 0
        n_term = n_trunc = 0
        for a in actions:
            jr = jenv.step(js, jnp.asarray(a))
            tr = env.step(ts, torch.from_numpy(a))
            assert_state_equal(tr.state, jr.state)
            for got, want in ((tr.reward, jr.reward), (tr.done, jr.done),
                              *((tr.info[k], jr.info[k]) for k in jr.info)):
                assert np_(got).dtype == np.asarray(want).dtype
                np.testing.assert_array_equal(np_(got), np.asarray(want))
            got, want = np_(tr.obs), np.asarray(jr.obs)
            assert got.dtype == want.dtype and got.shape == want.shape
            if depth:
                assert got.dtype == np.float64
                ulps = np.abs(got - want) / np.spacing(np.abs(want))
                worst = max(worst, float(ulps.max()))
                bad = (ulps > 4).reshape(B, -1).any(1)
            else:
                bad = (got != want).reshape(B, -1).any(1)
            if bad.any():
                envs = np.flatnonzero(bad)
                states.append(jax.tree_util.tree_map(lambda x: np.asarray(x)[envs], jr.state))
                frames.append(got[envs])
                moved += int((got[envs] != want[envs]).sum())
            n_term += int(np.asarray(jr.info["terminated"]).sum())
            n_trunc += int(np.asarray(jr.info["truncated"]).sum())
            js, ts = jr.state, tr.state
        assert tr.reward.dtype == torch.float64 and tr.state.episode_return.dtype == torch.float64
        if states:
            sub = jax.tree_util.tree_map(lambda *xs: np.concatenate(xs), *states)
            with jax.disable_jit():
                eager = np.asarray(jenv.game.observe_batch(sub))
            np.testing.assert_array_equal(np.concatenate(frames), eager)
    print(f"{name}: {moved} observation values in {sum(len(f) for f in frames)} env "
          f"frames differ from jitted JAX (depth: worst {worst:.1f} ulp), all equal to "
          "eager JAX")
    assert n_term > 0 and n_trunc > 0


def _drive(cfg, n_steps=60, seed=2):
    game = rt.SingleRoom(cfg)
    state = game.reset_batch(rt.rng.PRNGKey(seed)[None])
    rng = np.random.RandomState(seed)
    poses = []
    for _ in range(n_steps):
        poses.append(np_(state.pos_wu)[0].astype(np.float64))
        a = int(rng.choice(4, p=[0.55, 0.05, 0.2, 0.2]))
        state = game.step_batch(state, torch.tensor([a], dtype=torch.int32))
    return np.stack(poses), game.observe_batch(state), state


def test_float64_world_runs_and_matches_f32_closely():
    cfg64 = rt.EnvConfig(num_rays=32, height_camera_view_pu=32, dtype="float64")
    p64, obs64, s64 = _drive(cfg64)
    assert s64.pos_wu.dtype == torch.float64 and obs64.dtype == torch.uint32
    assert (p64 > 0.5).all() and (p64[:, 0] < cfg64.H - 0.5).all()
    p32, _, _ = _drive(rt.EnvConfig(num_rays=32, height_camera_view_pu=32))
    np.testing.assert_allclose(p64[:10], p32[:10], rtol=0, atol=1e-5)


def test_float64_depth_observation_dtype():
    cfg = rt.EnvConfig(num_rays=16, obs_type="depth", dtype="float64")
    env = rt.Env(rt.SingleRoom(cfg), num_envs=3, device="cpu")
    assert env.observation_space.dtype == torch.float64
    assert rt.Env(rt.SingleRoom(dataclasses.replace(cfg, dtype="float32")), num_envs=3,
                  device="cpu").observation_space.dtype == torch.float32
    state, obs = env.reset(rt.rng.PRNGKey(0))
    assert obs.dtype == torch.float64 and bool(torch.isfinite(obs).all())
    assert env.step(state, torch.zeros(3, dtype=torch.int32)).obs.dtype == torch.float64


@pytest.mark.parametrize("family", ["SingleRoom", "MultiGoalRoom"])
def test_float64_analytic_cast(family):
    config = {"SingleRoom": "EnvConfig", "MultiGoalRoom": "MultiGoalConfig"}[family]
    kw = dict(num_rays=33, height_camera_view_pu=24, raycast_backend="analytic",
              dtype="float64")
    with jax.enable_x64():
        jgame = getattr(rcw, family)(getattr(rcw, config)(**kw))
        game = getattr(rt, family)(getattr(rt, config)(**kw))
        js = jax.vmap(jgame.reset_single)(jax.random.split(jax.random.PRNGKey(9), 32))
        pos = np.random.default_rng(9).uniform([1, 1], [7, 15], size=(32, 2))
        pos[:8] = np.asarray(js.pos_wu)[:8]  # tile centres too
        js = js.replace(pos_wu=jnp.asarray(pos))
        ts = rt.EnvState.from_numpy({**{k: np.asarray(getattr(js, k)) for k in
                                        js.__dataclass_fields__ if getattr(js, k) is not None
                                        and k != "hw"}, "hw": js.hw})
        want = jax.vmap(jgame.cast_single)(js)
        got = game.cast_batch(ts)
        assert got.dist_wu.dtype == torch.float64 and np.asarray(want.dist_wu).dtype == np.float64
        wd, gd = np.asarray(want.dist_wu), np_(got.dist_wu)
        np.testing.assert_allclose(gd, wd, rtol=1e-6)
        cross = np.asarray(js.pos_wu)[:, None, :] + wd[..., None] * np.asarray(want.ray_dirs)
        axis = np.where(np.asarray(want.hit_dim) == 0, cross[..., 1], cross[..., 0])
        clear = np.abs(axis - np.round(axis)) > 1e-9
        assert clear.mean() > 0.99
        np.testing.assert_array_equal(np_(got.hit_dim)[clear], np.asarray(want.hit_dim)[clear])
        np.testing.assert_array_equal(np_(got.hit_tu)[clear], np.asarray(want.hit_tu)[clear])
