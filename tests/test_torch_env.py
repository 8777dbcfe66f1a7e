"""The whole slice: the port's Env(SingleRoom) against the JAX package's,
bit for bit, through reset, auto-reset, truncation and every observation.

64 rays x 48 px, 16 envs on the default 8x16 map, reset from three keys,
then 60 steps of numpy-seeded actions with max_episode_steps=20, so that
truncation and goal termination both fire.  Every state leaf, the obs, the
reward, done and every info entry are compared at every step (exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu.parallel import rollout as jrollout
from raycastworlds_tpu_torch.parallel import rollout
from raycastworlds_tpu_torch.state import LEAVES

B = 16
STEPS = 60
CFG = dict(num_rays=64, height_camera_view_pu=48, max_episode_steps=20)


def _jax_leaves(state):
    return {k: np.asarray(getattr(state, k)) for k in LEAVES}


def _assert_state_equal(got: rt.EnvState, want):
    w = _jax_leaves(want)
    g = got.to_numpy()
    for k in LEAVES:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _np(x):
    return x.detach().cpu().numpy()


# seeds whose trajectories reach the goal within the 60 steps
@pytest.mark.parametrize("seed", [2, 3, 4])
@pytest.mark.parametrize(
    "backend,final_obs",
    [("auto", False), ("crossing_kernel", True)],
    ids=["auto", "kernel_wrapper_final_obs"],
)
def test_env_trajectory_matches_jax(seed, backend, final_obs):
    jenv = rcw.Env(rcw.SingleRoom(rcw.EnvConfig(**CFG)), num_envs=B,
                   final_obs_in_info=final_obs)
    env = rt.Env(rt.SingleRoom(rt.EnvConfig(**CFG, raycast_backend=backend)),
                 num_envs=B, final_obs_in_info=final_obs, device="cpu")
    js, jobs = jenv.reset(jax.random.PRNGKey(seed))
    ts, tobs = env.reset(rt.rng.PRNGKey(seed))
    _assert_state_equal(ts, js)
    assert tobs.dtype == torch.uint32
    np.testing.assert_array_equal(_np(tobs), np.asarray(jobs))

    # biased towards moving forward, so that episodes also end at the goal
    actions = np.random.default_rng(seed).choice(
        4, size=(STEPS, B), p=[0.55, 0.05, 0.2, 0.2]
    ).astype(np.int32)
    n_term = n_trunc = 0
    for a in actions:
        jr = jenv.step(js, jnp.asarray(a))
        tr = env.step(ts, torch.from_numpy(a))
        _assert_state_equal(tr.state, jr.state)
        np.testing.assert_array_equal(_np(tr.obs), np.asarray(jr.obs))
        np.testing.assert_array_equal(_np(tr.reward), np.asarray(jr.reward))
        np.testing.assert_array_equal(_np(tr.done), np.asarray(jr.done))
        assert sorted(tr.info) == sorted(jr.info)
        for k in jr.info:
            np.testing.assert_array_equal(_np(tr.info[k]), np.asarray(jr.info[k]),
                                          err_msg=k)
        n_term += int(np.asarray(jr.info["terminated"]).sum())
        n_trunc += int(np.asarray(jr.info["truncated"]).sum())
        js, ts = jr.state, tr.state
    assert n_term > 0 and n_trunc > 0


def test_state_numpy_round_trip():
    jenv = rcw.Env(rcw.SingleRoom(rcw.EnvConfig(**CFG)), num_envs=B)
    js, _ = jenv.reset(jax.random.PRNGKey(7))
    js = jenv.step(js, jnp.zeros(B, jnp.int32)).state
    leaves = _jax_leaves(js)
    ts = rt.EnvState.from_numpy({**leaves, "hw": js.hw})
    assert ts.hw == (8, 16)
    assert ts.wall_words.dtype == torch.int32 and ts.rng_key.dtype == torch.int64
    back = ts.to_numpy()
    for k in LEAVES:
        assert back[k].dtype == leaves[k].dtype, k
        np.testing.assert_array_equal(back[k], leaves[k])
    # a state handed over from JAX steps on identically
    a = np.random.default_rng(8).integers(0, 4, size=B).astype(np.int32)
    env = rt.Env(rt.SingleRoom(rt.EnvConfig(**CFG)), num_envs=B, device="cpu")
    _assert_state_equal(env.step(ts, torch.from_numpy(a)).state,
                        jenv.step(js, jnp.asarray(a)).state)
    with pytest.raises(KeyError):
        rt.EnvState.from_numpy({"pos_wu": leaves["pos_wu"]})


def test_no_auto_reset_and_spaces():
    jenv = rcw.Env(rcw.SingleRoom(rcw.EnvConfig(**CFG)), num_envs=4, auto_reset=False)
    env = rt.Env(rt.SingleRoom(rt.EnvConfig(**CFG)), num_envs=4, auto_reset=False,
                 device="cpu")
    js, _ = jenv.reset(jax.random.PRNGKey(3))
    ts, _ = env.reset(rt.rng.PRNGKey(3))
    for _ in range(22):
        js = jenv.step(js, jnp.full(4, 2, jnp.int32)).state
        ts = env.step(ts, torch.full((4,), 2, dtype=torch.int32)).state
    _assert_state_equal(ts, js)
    assert bool(ts.done.all())  # truncated, not reset
    assert env.action_space == rt.Space(shape=(), dtype=torch.int32, n=4)
    assert env.observation_space.shape == jenv.observation_space.shape
    np.testing.assert_array_equal(
        _np(env.sample_action(rt.rng.PRNGKey(9))),
        np.asarray(jenv.sample_action(jax.random.PRNGKey(9))),
    )
    # a budget above the batch is clamped to it, as in the JAX package
    assert rt.Env(env.game, num_envs=4, reset_budget=9, device="cpu").reset_budget == 4


def test_default_device_is_cuda(monkeypatch):
    """No ``device`` means the card: without one the constructor raises and
    names ``device="cpu"``; it never falls back to the CPU."""
    game = rt.SingleRoom(rt.EnvConfig(**CFG))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        rt.Env(game, num_envs=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert rt.Env(game, num_envs=2).device == torch.device("cuda")
    assert rt.Env(game, num_envs=2, device="cpu").device == torch.device("cpu")


def test_rollouts_match_jax():
    """rollout_random is exact; the throughput program's final state is
    exact, and its float32 checksum sums the same terms in another order
    (24576 per step, XLA's tree against torch's), so it is held to rtol
    1e-4 (7e-6 measured)."""
    jenv = rcw.Env(rcw.SingleRoom(rcw.EnvConfig(**CFG)), num_envs=8)
    env = rt.Env(rt.SingleRoom(rt.EnvConfig(**CFG)), num_envs=8, device="cpu")
    js, _ = jenv.reset(jax.random.PRNGKey(11))
    ts, _ = env.reset(rt.rng.PRNGKey(11))

    jfin, jtraj = jax.jit(
        lambda s, k: jrollout.rollout_random(jenv, s, k, 6)
    )(js, jax.random.PRNGKey(12))
    tfin, ttraj = rollout.rollout_random(env, ts, rt.rng.PRNGKey(12), 6)
    _assert_state_equal(tfin, jfin)
    for f in ("obs", "action", "reward", "done"):
        np.testing.assert_array_equal(_np(getattr(ttraj, f)),
                                      np.asarray(getattr(jtraj, f)), err_msg=f)

    jrun = jax.jit(jrollout.steps_per_second_program(jenv, 25))
    jst, jacc = jrun(js, jax.random.PRNGKey(13))
    tst, tacc = rollout.steps_per_second_program(env, 25)(ts, rt.rng.PRNGKey(13))
    _assert_state_equal(tst, jst)
    np.testing.assert_allclose(float(tacc), float(jacc), rtol=1e-4)
