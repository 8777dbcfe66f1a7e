"""The port's gymnasium-style adapters against the JAX package's, exact:
every five-tuple, info entry, reset observation and render over seeded
action sequences, with explicit and unseeded resets, max_episode_steps
truncation, final_observation and a reset budget.  16 rays x 16 px; runs
stay under 60 steps (see tests/test_torch_env.py)."""

import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt

SMALL = dict(num_rays=16, height_camera_view_pu=16)


def _actions(seed, shape):
    # biased towards moving forward, so that episodes also end at the goal
    return np.random.default_rng(seed).choice(4, size=shape, p=[0.55, 0.05, 0.2, 0.2])


def _assert_info_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], np.ndarray), k
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def _assert_same(got, want):
    assert type(got) is type(want) or isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape


@pytest.mark.parametrize("seed", [0, 3])
def test_gym_adapter_matches_jax(seed):
    cfg = dict(**SMALL)
    jenv = rcw.GymAdapter(rcw.SingleRoom(rcw.EnvConfig(**cfg)), max_episode_steps=12)
    env = rt.GymAdapter(rt.SingleRoom(rt.EnvConfig(**cfg)), max_episode_steps=12,
                        device="cpu")
    assert env.action_space.n == jenv.action_space.n == 4
    assert env.observation_space.shape == jenv.observation_space.shape
    jobs, jinfo = jenv.reset(seed=seed)
    obs, info = env.reset(seed=seed)
    _assert_same(obs, np.asarray(jobs))
    assert info == jinfo == {}
    ends = {"terminated": 0, "truncated": 0}
    for t, a in enumerate(_actions(seed, 40)):
        want = jenv.step(int(a))
        got = env.step(int(a))
        for g, w in zip(got[:4], want[:4]):
            _assert_same(g, w)
        assert isinstance(got[1], float) and isinstance(got[2], bool)
        assert isinstance(got[3], bool)
        _assert_info_equal(got[4], want[4])
        if want[2] or want[3]:
            ends["terminated" if want[2] else "truncated"] += 1
            # terminations re-seed; truncations continue the stream
            s = t + 1 if want[2] else None
            _assert_same(env.reset(seed=s)[0], np.asarray(jenv.reset(seed=s)[0]))
    assert ends["truncated"] > 0
    frame = env.render()
    assert frame.shape == (16, 16, 3) and frame.dtype == np.uint8
    np.testing.assert_array_equal(frame, jenv.render())
    env.close()
    with pytest.raises(RuntimeError, match="reset"):
        env.step(0)


def test_gym_adapter_terminates_at_goal():
    """The player one step from the goal, facing it (as
    tests/test_wrappers.py places it): terminated, reward 1, as in JAX."""
    import jax.numpy as jnp

    from raycastworlds_tpu_torch.state import LEAVES

    cfg = rcw.EnvConfig(**SMALL)
    jenv = rcw.GymAdapter(rcw.SingleRoom(cfg))
    env = rt.GymAdapter(rt.SingleRoom(rt.EnvConfig(**SMALL)), device="cpu")
    jenv.reset(seed=0)
    env.reset(seed=0)
    jenv._state = jenv._state.replace(
        goal_tu=jnp.array([[4, 8]], jnp.int32),
        pos_wu=jnp.array([[4.5, 7.8]], jnp.float32),
        dir_au=jnp.array([cfg.num_directions // 4], jnp.int32),
    )
    env._state = rt.EnvState.from_numpy(
        {k: np.asarray(getattr(jenv._state, k)) for k in LEAVES}, device="cpu"
    ).replace(hw=env._state.hw)
    want, got = jenv.step(0), env.step(0)
    assert got[1:4] == want[1:4] == (1.0, True, False)
    _assert_same(got[0], np.asarray(want[0]))
    _assert_info_equal(got[4], want[4])


@pytest.mark.parametrize(
    "final_observation,reset_budget,max_steps",
    [(False, 0, 0), (True, 0, 3), (False, 2, 3)],
    ids=["plain", "final_observation", "reset_budget"])
def test_vector_adapter_matches_jax(final_observation, reset_budget, max_steps):
    b = 8
    kw = dict(**SMALL, max_episode_steps=max_steps)
    jv = rcw.GymVectorAdapter(rcw.SingleRoom(rcw.EnvConfig(**kw)), num_envs=b,
                              reset_budget=reset_budget, final_observation=final_observation)
    tv = rt.GymVectorAdapter(rt.SingleRoom(rt.EnvConfig(**kw)), num_envs=b,
                             reset_budget=reset_budget, final_observation=final_observation,
                             device="cpu")
    assert tv.single_observation_space.shape == jv.single_observation_space.shape
    for seed in (0, None, 7, None):
        jobs, _ = jv.reset(seed=seed)
        obs, info = tv.reset(seed=seed)
        assert info == {}
        _assert_same(obs, np.asarray(jobs))
    ended = 0
    for a in _actions(1, (12, b)):
        want = jv.step(a)
        got = tv.step(a)
        for g, w in zip(got[:4], want[:4]):
            _assert_same(g, np.asarray(w))
        _assert_info_equal(got[4], want[4])
        assert got[2] is got[4]["terminated"] and got[3] is got[4]["truncated"]
        assert ("final_observation" in got[4]) == final_observation
        if final_observation:
            done = got[2] | got[3]
            np.testing.assert_array_equal(got[4]["final_observation"][~done], got[0][~done])
        ended += int((got[2] | got[3]).sum())
    assert ended > 0 or not max_steps
    frames = tv.render()
    assert frames.shape == (b, 16, 16, 3) and frames.dtype == np.uint8
    np.testing.assert_array_equal(frames, jv.render())
    # actions may also be a tensor
    got = tv.step(torch.zeros(b, dtype=torch.int64))
    _assert_same(got[0], np.asarray(jv.step(np.zeros(b, np.int64))[0]))


@pytest.mark.parametrize("adapter", ["GymAdapter", "GymVectorAdapter"])
def test_adapters_reject_multi_player(adapter):
    cfg = rt.MultiPlayerConfig(num_players=2, **SMALL)
    kw = {} if adapter == "GymAdapter" else dict(num_envs=2)
    with pytest.raises(ValueError, match="single-agent"):
        getattr(rt, adapter)(rt.MultiPlayerRoom(cfg), device="cpu", **kw)


@pytest.mark.parametrize("adapter", ["GymAdapter", "GymVectorAdapter"])
def test_adapters_default_to_the_card(adapter):
    """No device given means the CUDA device: without a card the adapters
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the default where there is no card")
    kw = {} if adapter == "GymAdapter" else dict(num_envs=2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(rt, adapter)(rt.SingleRoom(rt.EnvConfig(**SMALL)), **kw)
