"""The port's feedforward PPO trainer against the JAX package's, on the CPU.

SingleRoom at 16 rays x 16 px, 8 envs, hidden 32, rollout 4, 2 minibatches,
episodes truncated after 3 steps (so that GAE's done masking is in every
rollout).  Params and optimizer state are carried from the JAX side
(``parallel/params.py``); inputs come from numpy seeds.  Tolerances:
preprocessing exact; forward outputs within 1e-5 of the largest magnitude
in float32, 2e-2 in bfloat16 (the two frameworks round bf16 at other
places); GAE within 4 float32 ulp (XLA contracts the delta into an FMA
under jit); loss, gradients and one clipped Adam update within 1e-5; a
whole train step with identical trajectories and env states, params and
metrics within 1e-4 (four updates compound the ulp differences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu.parallel import ppo as jppo
from raycastworlds_tpu_torch.parallel import ppo
from raycastworlds_tpu_torch.parallel.params import actor_critic_from_flax, adam_from_optax
from raycastworlds_tpu_torch.state import LEAVES, OPTIONAL_LEAVES

SMALL = dict(num_rays=16, height_camera_view_pu=16, obs_type="camera_gray",
             max_episode_steps=3)
B, HIDDEN = 8, 32
PPO = dict(rollout_steps=4, num_minibatches=2)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (0 where both are 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else float(np.abs(got).max())


def assert_params_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        assert rel_err(got[k].numpy(), want[k].numpy()) <= tol, k


def port_state(jts, **kw):
    """The port's train state from the JAX one: params, optimizer state, env
    state and key carried over."""
    leaves = {k: np.asarray(getattr(jts.env_state, k))
              for k in LEAVES + OPTIONAL_LEAVES if getattr(jts.env_state, k, None) is not None}
    return dict(
        params=actor_critic_from_flax(np_tree(jts.params)),
        opt_state=adam_from_optax(np_tree(jts.opt_state)),
        env_state=rt.EnvState.from_numpy(leaves),
        key=torch.from_numpy(np.asarray(jts.key).astype(np.int64)),
        update_count=int(jts.update_count),
        **kw,
    )


def assert_env_state_equal(got: rt.EnvState, want):
    g = got.to_numpy()
    for k in g:
        np.testing.assert_array_equal(g[k], np.asarray(getattr(want, k)), err_msg=k)


# ---------------------------------------------------------------------------
# preprocess_obs
# ---------------------------------------------------------------------------

OBS_CASES = {
    "camera_u32": {},
    "camera_rgb": {},
    "camera_gray": {},
    "camera_pal8": {},
    "camera_pal8_xor": dict(wall_texture="xor", texture_cells=16),
    "camera_gray_u8": {},
    "depth": {},
    "tile_grid": {},
}


def random_obs(cfg, rng, n=3):
    shape = (n,) + cfg.obs_shape
    t = cfg.obs_type
    if t == "camera_u32":
        return rng.integers(0, 2**24, size=shape, dtype=np.uint32)
    if t in ("camera_rgb", "camera_gray_u8"):
        return rng.integers(0, 256, size=shape, dtype=np.uint8)
    if t == "camera_pal8":
        return rng.integers(0, len(cfg.palette_np), size=shape).astype(np.uint8)
    if t == "tile_grid":
        return rng.integers(0, 4, size=shape, dtype=np.int32)
    return rng.uniform(0, 20, size=shape).astype(np.float32)


@pytest.mark.parametrize("case", list(OBS_CASES))
def test_preprocess_obs_exact(case):
    kw = dict(num_rays=16, height_camera_view_pu=12, obs_type=case.split("_xor")[0],
              **OBS_CASES[case])
    jcfg, cfg = rcw.EnvConfig(**kw), rt.EnvConfig(**kw)
    obs = random_obs(cfg, np.random.default_rng(len(case)))
    want = np.asarray(jppo.preprocess_obs(jcfg, jnp.asarray(obs)))
    t = torch.from_numpy(obs.view(np.int32)).view(torch.uint32) if obs.dtype == np.uint32 \
        else torch.from_numpy(obs)
    got = ppo.preprocess_obs(cfg, t)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "camera_pal8_xor":
        assert len(cfg.palette_np) > 64  # the one-hot branch of the JAX package


@pytest.mark.parametrize("obs_type", ["top_u32", "top_rgb"])
def test_preprocess_top_views_raise(obs_type):
    cfg = rt.EnvConfig(num_rays=16, height_camera_view_pu=12, obs_type=obs_type)
    with pytest.raises(ValueError, match="top views are debug renders"):
        ppo.preprocess_obs(cfg, torch.zeros((1,) + cfg.obs_shape, dtype=torch.uint8))


# ---------------------------------------------------------------------------
# ActorCritic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trunk,shape", [("conv", (13, 16, 3)), ("patch", (16, 24, 1)),
                                         ("mlp", (16, 16, 1)), ("conv", (16,))])
def test_actor_critic_matches_flax(trunk, shape, dtype):
    """Forward outputs on carried params; (13, 16) pads SAME asymmetrically
    (the odd pixel after), (16,) is a vector observation."""
    x = np.random.default_rng(1).random((6,) + shape).astype(np.float32)
    jnet = jppo.ActorCritic(hidden=HIDDEN, trunk=trunk, dtype=getattr(jnp, dtype))
    params = jnet.init(jax.random.PRNGKey(2), jnp.asarray(x))
    jl, jv = jnet.apply(params, jnp.asarray(x))
    net = ppo.ActorCritic(shape, 4, HIDDEN, getattr(torch, dtype), trunk)
    tp = actor_critic_from_flax(np_tree(params))
    assert sorted(tp) == sorted(k for k, _ in net.named_parameters())
    tl, tv = functional_call(net, tp, (torch.from_numpy(x),))
    assert tl.dtype == tv.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert rel_err(tl.numpy(), jl) <= tol
    assert rel_err(tv.numpy(), jv) <= tol


@pytest.mark.parametrize("trunk", ["conv", "patch", "mlp"])
def test_init_params_shapes_and_variance(trunk):
    """The port's own init: flax's shapes, no NaN, zero biases, and every
    kernel lecun normal (pooled over the kernels, each scaled by
    sqrt(fan_in): variance 1 within 10%, nothing beyond 2 std)."""
    shape = (32, 32, 1)
    net = ppo.ActorCritic(shape, 4, 64, torch.float32, trunk)
    params = ppo.init_params(net, rt.rng.PRNGKey(7), "cpu")
    flax_params = jppo.ActorCritic(hidden=64, trunk=trunk).init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + shape))
    want = actor_critic_from_flax(np_tree(flax_params))
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    scaled = []
    for k, v in params.items():
        assert torch.isfinite(v).all(), k
        if k.endswith("bias"):
            assert not v.any(), k
        else:
            scaled.append((v * np.sqrt(v[0].numel())).flatten())
    z = torch.cat(scaled)
    assert abs(float(z.var()) - 1.0) < 0.1
    assert float(z.abs().max()) <= 2.0 / ppo._TRUNC_STD + 1e-6
    again = ppo.init_params(net, rt.rng.PRNGKey(7), "cpu")
    assert all(torch.equal(again[k], params[k]) for k in params)


# ---------------------------------------------------------------------------
# GAE, loss, optimizer
# ---------------------------------------------------------------------------


def test_compute_gae_matches_jax():
    """Dones anywhere (terminations and truncations alike), one at the last
    step, within 4 float32 ulp of the magnitude of the returns."""
    r = np.random.default_rng(3)
    t, b = 16, 32
    reward = (r.random((t, b)) < 0.1).astype(np.float32)
    value = r.normal(size=(t, b)).astype(np.float32)
    done = r.random((t, b)) < 0.2
    done[-1, :4] = True
    last = r.normal(size=b).astype(np.float32)
    ja, jt = jax.jit(lambda *a: jppo.compute_gae(*a, 0.99, 0.95))(
        *map(jnp.asarray, (reward, value, done, last)))
    ga, gt = ppo.compute_gae(*map(torch.from_numpy, (reward, value, done, last)), 0.99, 0.95)
    for got, want in ((ga, ja), (gt, jt)):
        want = np.asarray(want)
        ulp = np.spacing(np.float32(np.abs(want).max()))
        assert np.abs(got.numpy() - want).max() <= 4 * ulp


def test_gae_masks_the_bootstrap_at_truncation():
    """Reproduced reference behaviour: a done at the last step (truncated
    or terminated alike) drops the last value from the advantage."""
    reward = torch.zeros(1, 2)
    value = torch.tensor([[0.5, 0.5]])
    done = torch.tensor([[True, False]])
    adv, _ = ppo.compute_gae(reward, value, done, torch.tensor([10.0, 10.0]), 0.99, 0.95)
    assert adv[0, 0] == -0.5
    assert adv[0, 1] == np.float32(0.99) * 10.0 - 0.5


def random_batch(r, n, shape):
    return {
        "obs": r.random((n,) + shape).astype(np.float32),
        "action": r.integers(0, 4, size=n).astype(np.int32),
        "log_prob": np.log(r.uniform(0.1, 0.5, size=n)).astype(np.float32),
        "advantage": r.normal(size=n).astype(np.float32),
        "target": r.normal(size=n).astype(np.float32),
    }


@pytest.mark.parametrize("trunk", ["conv", "mlp"])
def test_ppo_loss_and_grads_match_jax(trunk):
    r = np.random.default_rng(4)
    shape = (16, 16)
    jcfg, cfg = rcw.EnvConfig(**SMALL), rt.EnvConfig(**SMALL)
    batch = random_batch(r, 32, shape)
    jnet = jppo.ActorCritic(hidden=HIDDEN, trunk=trunk)
    params = jnet.init(jax.random.PRNGKey(5), jnp.zeros((1,) + shape + (1,)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jppo.ppo_loss(jnet, jcfg, jppo.PPOConfig(), p, jb), has_aux=True))(params)
    net = ppo.ActorCritic(shape + (1,), 4, HIDDEN, torch.float32, trunk)
    tp = {k: v.requires_grad_(True) for k, v in actor_critic_from_flax(np_tree(params)).items()}
    loss, m = ppo.ppo_loss(net, cfg, ppo.PPOConfig(), tp,
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(tp.values()))
    for k in jm:
        assert rel_err(float(m[k].detach()), float(jm[k])) <= 1e-5, k
    want = actor_critic_from_flax(np_tree(jg))
    assert_params_close(dict(zip(tp, grads)), want, 1e-5)


@pytest.mark.parametrize("grad_scale", [0.01, 100.0], ids=["below_max_norm", "clipped"])
def test_clip_adam_update_matches_optax(grad_scale):
    """One clip + Adam update from carried params and a carried optimizer
    state three updates old (count, mu and nu non-zero)."""
    r = np.random.default_rng(6)
    jnet = jppo.ActorCritic(hidden=HIDDEN, trunk="mlp")
    params = jnet.init(jax.random.PRNGKey(6), jnp.zeros((1, 16, 16, 1)))
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
    opt_state = tx.init(params)
    update = jax.jit(tx.update)

    def grads_like(scale):
        return jax.tree_util.tree_map(
            lambda p: jnp.asarray(r.normal(size=p.shape).astype(np.float32) * scale), params)

    for _ in range(3):
        upd, opt_state = update(grads_like(1.0), opt_state, params)
        params = optax.apply_updates(params, upd)
    grads = grads_like(grad_scale)
    upd, new_state = update(grads, opt_state, params)
    new_params = optax.apply_updates(params, upd)

    tp, ts = actor_critic_from_flax(np_tree(params)), adam_from_optax(np_tree(opt_state))
    assert ts["count"] == 3
    opt = ppo.Optimizer(tp, ts, ppo.PPOConfig())
    tg = actor_critic_from_flax(np_tree(grads))
    opt.apply([tg[k] for k in opt.params])
    got_params, got_state = opt.state()
    assert_params_close(got_params, actor_critic_from_flax(np_tree(new_params)), 1e-5)
    want_state = adam_from_optax(np_tree(new_state))
    assert got_state["count"] == want_state["count"] == 4
    for m in ("mu", "nu"):
        assert_params_close(got_state[m], want_state[m], 1e-5)
    # the carried state was not changed
    assert torch.equal(ts["mu"]["trunk.weight"],
                       adam_from_optax(np_tree(opt_state))["mu"]["trunk.weight"])


# ---------------------------------------------------------------------------
# A whole train step
# ---------------------------------------------------------------------------


def jax_train_step(jtr, jts):
    """The JAX trainer's train step (``_train_step_impl``) run as its two
    jitted phases, so that the rollout is compiled once and its trajectory
    is seen: returns (rollout phase outputs, new train state, metrics)."""
    key, k_roll, k_perm = jax.random.split(jts.key, 3)
    roll = jax.jit(jtr._rollout_phase)(jts, k_roll)
    env_state, traj, adv, target, aux = roll
    params, opt_state, metrics = jax.jit(jtr._update_phase)(
        jts.params, jts.opt_state, k_perm, traj, adv, target)
    metrics.update(aux)
    return roll, jppo.TrainState(params, opt_state, env_state, key,
                                 jts.update_count + 1), metrics


def _trainer_pair(game, jgame, trunk):
    jenv = rcw.Env(jgame, num_envs=B, jit=False)
    jtr = jppo.PPOTrainer(jenv, jppo.PPOConfig(**PPO), hidden=HIDDEN, trunk=trunk)
    jts = jtr.init(jax.random.PRNGKey(0))
    jroll, jts2, jm = jax_train_step(jtr, jts)
    env = rt.Env(game, num_envs=B, device="cpu")
    tr = ppo.PPOTrainer(env, ppo.PPOConfig(**PPO), hidden=HIDDEN, trunk=trunk)
    ts = ppo.TrainState(**port_state(jts))
    with torch.no_grad():
        roll = tr._rollout_phase(ts, rt.rng.split(ts.key, 3)[1])
    ts2, m = tr.train_step(ts)
    return dict(jroll=jroll, jts2=jts2, jm=jm, roll=roll, ts2=ts2, m=m, tr=tr, ts=ts)


@pytest.fixture(scope="module")
def single_room():
    return _trainer_pair(rt.SingleRoom(rt.EnvConfig(**SMALL)),
                         rcw.SingleRoom(rcw.EnvConfig(**SMALL)), "conv")


@pytest.fixture(scope="module")
def multi_player():
    kw = dict(SMALL, obs_type="camera_u32")
    return _trainer_pair(rt.MultiPlayerRoom(rt.MultiPlayerConfig(**kw)),
                         rcw.MultiPlayerRoom(rcw.MultiPlayerConfig(**kw)), "mlp")


@pytest.fixture(params=["single_room", "multi_player"])
def pair(request):
    return request.getfixturevalue(request.param)


def test_train_step_trajectory_identical(pair):
    """The rollout of one train step: obs, actions, rewards and dones equal
    (obs within 4 ulp: XLA's FMA moves camera_gray), log-probs and values
    within 1e-5, the final env state exact.  MultiPlayerRoom folds its
    players into the batch in both."""
    env_state, traj, adv, target, aux = pair["roll"]
    jstate, jtraj, jadv, jtarget, jaux = pair["jroll"]
    for f in ("action", "reward", "done"):
        np.testing.assert_array_equal(getattr(traj, f).numpy(), np.asarray(getattr(jtraj, f)),
                                      err_msg=f)
    obs, jobs = traj.obs.numpy(), np.asarray(jtraj.obs)
    if obs.dtype == np.float32:
        np.testing.assert_array_max_ulp(obs, jobs, maxulp=4)
    else:
        np.testing.assert_array_equal(obs.view(np.uint32), jobs)
    for got, want in ((traj.log_prob, jtraj.log_prob), (traj.value, jtraj.value),
                      (adv, jadv), (target, jtarget)):
        assert rel_err(got.numpy(), want) <= 1e-5
    assert_env_state_equal(env_state, jstate)
    assert sorted(aux) == sorted(jaux)
    for k in aux:
        assert rel_err(float(aux[k]), float(jaux[k])) <= 1e-5, k
    assert int(traj.done.sum()) > 0


def test_train_step_matches_jax(pair):
    ts2, m, jts2, jm = pair["ts2"], pair["m"], pair["jts2"], pair["jm"]
    assert sorted(m) == sorted(jm)
    for k in jm:
        assert rel_err(float(m[k]), float(jm[k])) <= 1e-4, k
    assert_params_close(ts2.params, actor_critic_from_flax(np_tree(jts2.params)), 1e-4)
    want_opt = adam_from_optax(np_tree(jts2.opt_state))
    assert ts2.opt_state["count"] == want_opt["count"] == 2 * PPO["num_minibatches"]
    assert_env_state_equal(ts2.env_state, jts2.env_state)
    np.testing.assert_array_equal(ts2.key.numpy().astype(np.uint32), np.asarray(jts2.key))
    assert ts2.update_count == int(jts2.update_count) == 1


def test_train_step_leaves_its_input(single_room):
    """A train state is a value: stepping it again gives the same result."""
    tr, ts = single_room["tr"], single_room["ts"]
    again, m = tr.train_step(ts)
    assert all(torch.equal(again.params[k], single_room["ts2"].params[k]) for k in again.params)
    assert float(m["loss"]) == float(single_room["m"]["loss"])


def test_train_history():
    """``train`` returns the JAX trainer's history dicts: every metric,
    ``update`` and ``elapsed_s``, every ``log_every`` updates and at the
    last."""
    env = rt.Env(rt.SingleRoom(rt.EnvConfig(**SMALL)), num_envs=B, device="cpu")
    tr = ppo.PPOTrainer(env, ppo.PPOConfig(**PPO), hidden=HIDDEN, trunk="mlp")
    ts, history = tr.train(rt.rng.PRNGKey(1), 3, log_every=2)
    assert [h["update"] for h in history] == [2, 3]
    assert set(history[0]) == {"loss", "policy_loss", "value_loss", "entropy",
                               "episodes_finished", "success_rate", "reward_per_step",
                               "update", "elapsed_s"}
    assert all(np.isfinite(v) for h in history for v in h.values())
    assert ts.update_count == 3
