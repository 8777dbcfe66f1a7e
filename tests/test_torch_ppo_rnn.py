"""The port's recurrent (GRU) PPO trainer against the JAX package's, on the
CPU: the network on carried params (float32 within 1e-5 of the largest
magnitude, bfloat16 within 2e-2), the GRU cell written as flax's, the init,
the trainer's errors, and one whole train step from carried params, env
state and key: the final env state exact, the hidden carry, params and
metrics within 1e-4.  SingleRoom at 16 rays x 16 px, 8 envs, hidden 32,
rollout 4, 2 minibatches, episodes truncated after 3 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu.parallel import ppo as jppo
from raycastworlds_tpu.parallel import ppo_rnn as jrnn
from raycastworlds_tpu_torch.parallel import ppo, ppo_rnn
from raycastworlds_tpu_torch.parallel.params import adam_from_optax, recurrent_from_flax
from test_torch_ppo import (
    B, HIDDEN, PPO, SMALL, assert_env_state_equal, assert_params_close, np_tree,
    port_state, rel_err,
)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trunk,shape", [("conv", (13, 16, 3)), ("mlp", (16, 16, 1)),
                                         ("patch", (16, 16, 1))])
def test_recurrent_actor_critic_matches_flax(trunk, shape, dtype):
    r = np.random.default_rng(2)
    x = r.random((6,) + shape).astype(np.float32)
    h = np.tanh(r.normal(size=(6, HIDDEN))).astype(np.float32)
    jnet = jrnn.RecurrentActorCritic(hidden=HIDDEN, trunk=trunk, dtype=getattr(jnp, dtype))
    params = jnet.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(h))
    want = jnet.apply(params, jnp.asarray(x), jnp.asarray(h))
    net = ppo_rnn.RecurrentActorCritic(shape, 4, HIDDEN, getattr(torch, dtype), trunk)
    tp = recurrent_from_flax(np_tree(params))
    assert sorted(tp) == sorted(k for k, _ in net.named_parameters())
    got = functional_call(net, tp, (torch.from_numpy(x), torch.from_numpy(h)))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert rel_err(g.numpy(), w) <= tol


def test_gru_cell_has_flax_params():
    """ir/iz/in with a bias, hr/hz without, hn with one: no torch.nn.GRUCell
    b_hr/b_hz."""
    cell = ppo_rnn.GRUCell(5, 3, torch.float32)
    names = sorted(k for k, _ in cell.named_parameters())
    assert names == sorted(["ir.weight", "ir.bias", "iz.weight", "iz.bias", "in.weight",
                            "in.bias", "hr.weight", "hz.weight", "hn.weight", "hn.bias"])


def test_init_params_recurrent_kernels_orthogonal():
    net = ppo_rnn.RecurrentActorCritic((16, 16, 1), 4, 64, torch.float32, "mlp")
    params = ppo.init_params(net, rt.rng.PRNGKey(4), "cpu")
    for k in ("gru.hr.weight", "gru.hz.weight", "gru.hn.weight"):
        w = params[k]
        torch.testing.assert_close(w @ w.T, torch.eye(64), atol=1e-5, rtol=0)
    assert not params["gru.hn.bias"].any()
    z = params["gru.ir.weight"] * 8.0  # sqrt(fan_in = 64)
    assert abs(float(z.var()) - 1.0) < 0.1


def test_trainer_errors():
    small = dict(num_rays=16, height_camera_view_pu=16)
    mp = rt.Env(rt.MultiPlayerRoom(rt.MultiPlayerConfig(**small)), num_envs=8, device="cpu")
    with pytest.raises(ValueError, match="single-agent"):
        ppo_rnn.RecurrentPPOTrainer(mp, ppo.PPOConfig(**PPO))
    env = rt.Env(rt.SingleRoom(rt.EnvConfig(**small)), num_envs=6, device="cpu")
    with pytest.raises(ValueError, match="must divide by num_minibatches"):
        ppo_rnn.RecurrentPPOTrainer(env, ppo.PPOConfig(num_minibatches=4))


@pytest.fixture(scope="module")
def pair():
    jenv = rcw.Env(rcw.SingleRoom(rcw.EnvConfig(**SMALL)), num_envs=B, jit=False)
    jtr = jrnn.RecurrentPPOTrainer(jenv, jppo.PPOConfig(**PPO), hidden=HIDDEN, trunk="conv")
    jts = jtr.init(jax.random.PRNGKey(0))
    # a carried hidden state that is not zero, so that the replay starts from it
    jts = jts._replace(hidden=jnp.asarray(
        np.tanh(np.random.default_rng(5).normal(size=(B, HIDDEN))).astype(np.float32)))
    jts2, jm = jtr.train_step(jts)
    env = rt.Env(rt.SingleRoom(rt.EnvConfig(**SMALL)), num_envs=B, device="cpu")
    tr = ppo_rnn.RecurrentPPOTrainer(env, ppo.PPOConfig(**PPO), hidden=HIDDEN, trunk="conv")
    st = port_state(jts, hidden=torch.from_numpy(np.array(jts.hidden)))
    st["params"] = recurrent_from_flax(np_tree(jts.params))
    ts = ppo_rnn.RnnTrainState(**st)
    ts2, m = tr.train_step(ts)
    with torch.no_grad():
        roll = tr._rollout_phase(ts, rt.rng.split(ts.key, 3)[1])
    return dict(jts2=jts2, jm=jm, ts2=ts2, m=m, roll=roll)


def test_rnn_train_step_rollout_matches_jax(pair):
    """The rollout's end: the final env state exact (every action taken
    alike), the hidden carry within 1e-5, the episodes counted alike."""
    ts2, jts2, m, jm = pair["ts2"], pair["jts2"], pair["m"], pair["jm"]
    assert_env_state_equal(ts2.env_state, jts2.env_state)
    assert rel_err(ts2.hidden.numpy(), jts2.hidden) <= 1e-5
    assert float(m["episodes_finished"]) == float(jm["episodes_finished"]) > 0
    data = pair["roll"][2]
    assert bool(data["done"].any())


def test_rnn_train_step_matches_jax(pair):
    ts2, jts2, m, jm = pair["ts2"], pair["jts2"], pair["m"], pair["jm"]
    assert sorted(m) == sorted(jm)
    for k in jm:
        assert rel_err(float(m[k]), float(jm[k])) <= 1e-4, k
    assert_params_close(ts2.params, recurrent_from_flax(np_tree(jts2.params)), 1e-4)
    want = adam_from_optax(np_tree(jts2.opt_state))
    assert ts2.opt_state["count"] == want["count"] == 2 * PPO["num_minibatches"]
    for k in ("mu", "nu"):
        assert_params_close(ts2.opt_state[k], want[k], 1e-4)
    np.testing.assert_array_equal(ts2.key.numpy().astype(np.uint32), np.asarray(jts2.key))
    assert ts2.update_count == 1
