"""Checkpoints of the port's trainer states: a round trip gives every leaf
back exactly (dtypes and devices of the target), a resumed trainer
continues bit for bit as an uninterrupted one on the CPU, and a checkpoint
of another structure is refused."""

import json

import numpy as np
import pytest

import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch.parallel import ppo, ppo_rnn
from raycastworlds_tpu_torch.utils import checkpoint

SMALL = dict(num_rays=16, height_camera_view_pu=16, obs_type="camera_gray",
             max_episode_steps=3)
PPO = ppo.PPOConfig(rollout_steps=4, num_minibatches=2)


def trainer(recurrent, game=None):
    env = rt.Env(game or rt.SingleRoom(rt.EnvConfig(**SMALL)), num_envs=8, device="cpu")
    cls = ppo_rnn.RecurrentPPOTrainer if recurrent else ppo.PPOTrainer
    return cls(env, PPO, hidden=32, trunk="mlp")


def flat(tree):
    out = {}
    checkpoint._flatten(tree, "", out)
    return out


def assert_same(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("recurrent", [False, True], ids=["ppo", "gru"])
def test_round_trip(tmp_path, recurrent):
    tr = trainer(recurrent)
    ts, _ = tr.train_step(tr.init(rt.rng.PRNGKey(1)))
    path = checkpoint.save(str(tmp_path / "ckpt"), ts, {"update": 1})
    assert path.endswith(".npz")
    fresh = tr.init(rt.rng.PRNGKey(2))
    back = checkpoint.restore(path, fresh)
    assert type(back) is type(ts) and back.update_count == 1
    assert back.env_state.hw == ts.env_state.hw
    assert_same(back, ts)
    with np.load(path) as data:
        assert json.loads(str(data["__meta__"])) == {"update": 1}
        assert "env_state/pos_wu" in data.files and "params/policy.weight" in data.files
        assert ("hidden" in data.files) == recurrent


@pytest.mark.parametrize("recurrent", [False, True], ids=["ppo", "gru"])
def test_resume_continues_bit_for_bit(tmp_path, recurrent):
    tr = trainer(recurrent)
    ts1, _ = tr.train_step(tr.init(rt.rng.PRNGKey(3)))
    want, want_m = tr.train_step(ts1)
    path = checkpoint.save(str(tmp_path / "ckpt.npz"), ts1)
    resumed = checkpoint.restore(path, trainer(recurrent).init(rt.rng.PRNGKey(4)))
    got, got_m = tr.train_step(resumed)
    assert_same(got, want)
    assert {k: float(v) for k, v in got_m.items()} == {k: float(v) for k, v in want_m.items()}


def test_multi_player_env_state_round_trip(tmp_path):
    """An env state with a player axis and the budgeted-reset leaf alone."""
    env = rt.Env(rt.MultiPlayerRoom(rt.MultiPlayerConfig(num_rays=8, height_camera_view_pu=8)),
                 num_envs=3, device="cpu", reset_budget=1)
    state, _ = env.reset(rt.rng.PRNGKey(5))
    state = env.step(state, env.sample_action(rt.rng.PRNGKey(6))).state
    path = checkpoint.save(str(tmp_path / "env"), state)
    assert_same(checkpoint.restore(path, env.reset(rt.rng.PRNGKey(7))[0]), state)


def test_restore_refuses_another_structure(tmp_path):
    ts = trainer(False).init(rt.rng.PRNGKey(8))
    path = checkpoint.save(str(tmp_path / "ff"), ts)
    with pytest.raises(ValueError, match="leaves differ"):
        checkpoint.restore(path, trainer(True).init(rt.rng.PRNGKey(8)))
    narrow = ppo.PPOTrainer(trainer(False).env, PPO, hidden=16, trunk="mlp")
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(path, narrow.init(rt.rng.PRNGKey(8)))
    with pytest.raises(TypeError, match="cannot checkpoint"):
        checkpoint.save(str(tmp_path / "bad"), {"x": object()})
