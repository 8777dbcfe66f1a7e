"""The port over ranks: gloo processes on the CPU against the JAX package on
the conftest's virtual devices.

Two launches of ``mesh.launch`` (2 and 4 ranks, each rank one CPU thread,
the store under ``tmp_path``) run every case of their topology and send
back numpy results; the JAX side runs here on ``make_mesh(dp=2)`` and
``make_mesh(dp=2, mp=2)`` of the virtual devices.  The rank bodies are this
module's functions and import no JAX (each rank checks): JAX is imported
only inside the fixtures and tests.

* Env, dp = 2 and 4: SingleRoom reset + 8 ``rollout_random`` steps, a
  budgeted RandomRoom (budget 6 of 8 envs that all end in one step, so the
  budget reaches across a shard boundary and leaves envs frozen) and
  MultiPlayerRoom: the assembled states equal the one-process port's and
  the JAX ``Env``'s bit for bit; ``steps_per_second_program``'s checksum
  within rtol 1e-4 of JAX's (summed across ranks in another order); the
  budgeted steps one ``mesh_collectives`` each.
* Trainers from params carried from the JAX trainer on a mesh of the same
  shape (SingleRoom 16 x 16 gray, 8 envs, hidden 32, rollout 4, 2
  minibatches, episodes truncated after 3 steps): the feedforward trainer
  at dp = 2 (conv) and dp = 2 x mp = 2 (conv and mlp), the GRU trainer at
  dp = 2.  The rollout is identical (actions, rewards, dones, final env
  state, key; log-probs, values, advantages and targets within 1e-5, since
  under mp the logits sum in another order), metrics within 1e-4
  relative, params and Adam moments within 1e-4 of each tensor's largest
  magnitude, and the replicated params bit-identical on every rank.
* Checkpoints: a dp = 2 save holds the leaves and values of a one-process
  save; restored onto dp = 2 and onto one process, a state continues bit
  for bit.
* ``dryrun.dryrun_multichip(4)``, ``bench_scaling`` and ``train --mesh``
  over the ranks, and the errors.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch import bench_scaling, dryrun, train
from raycastworlds_tpu_torch.parallel import mesh as mesh_lib
from raycastworlds_tpu_torch.parallel import ppo, ppo_rnn
from raycastworlds_tpu_torch.parallel.rollout import rollout_random, steps_per_second_program
from raycastworlds_tpu_torch.utils import checkpoint, profiling

SMALL = dict(num_rays=16, height_camera_view_pu=16, obs_type="camera_gray",
             max_episode_steps=3)
B, HIDDEN, T = 8, 32, 8
PPO = dict(rollout_steps=4, num_minibatches=2)
BUDGET = 6
# name -> (family, its config, keyword arguments, Env keyword arguments)
ENV_CASES = {
    "single_room": ("SingleRoom", "EnvConfig", dict(num_rays=16, height_camera_view_pu=16), {}),
    "random_room_budget": ("RandomRoom", "RandomRoomConfig",
                           dict(num_rays=16, height_camera_view_pu=16, max_episode_steps=4,
                                height_tile_map_tu=10, width_tile_map_tu=10,
                                raycast_backend="scan"), dict(reset_budget=BUDGET)),
    "multi_player": ("MultiPlayerRoom", "MultiPlayerConfig",
                     dict(num_rays=16, height_camera_view_pu=16), {}),
}
TAIL = [1, 0, 0, 2, 0, 0, 0]


def make_env(case, mesh=None, device=None):
    family, config, kw, env_kw = ENV_CASES[case]
    game = getattr(rt, family)(getattr(rt, config)(**kw))
    return rt.Env(game, num_envs=B, mesh=mesh, device=device, **env_kw)


def flat(tree):
    out = {}
    checkpoint._flatten(tree, "", out)
    return out


def env_runs(mesh=None):
    """Each env case: reset(PRNGKey(0)) + T random steps (PRNGKey(1));
    SingleRoom also the throughput program's 8 steps (PRNGKey(2)).  Returns
    the global final states' leaves, the checksum and the all-reduces of
    the budgeted case's reset and steps."""
    out = {}
    for case in ENV_CASES:
        env = make_env(case, mesh, None if mesh else "cpu")
        before = profiling.total("mesh_collectives")
        state, _ = env.reset(rt.rng.PRNGKey(0))
        state, _ = rollout_random(env, state, rt.rng.PRNGKey(1), T)
        if env.reset_budget:
            out["budget_collectives"] = profiling.total("mesh_collectives") - before
        out[case] = state if mesh is None else mesh_lib.gather_env_state(state, mesh)
        if case == "single_room":
            state, _ = env.reset(rt.rng.PRNGKey(0))
            state, acc = steps_per_second_program(env, 8)(state, rt.rng.PRNGKey(2))
            out["sps"] = state if mesh is None else mesh_lib.gather_env_state(state, mesh)
            out["checksum"] = float(acc)
    return {k: v if isinstance(v, (int, float)) else v.to_numpy() for k, v in out.items()}


def tail(env, state):
    for a in TAIL:
        state = env.step(state, torch.full((env.local_envs,), a, dtype=torch.int32)).state
    return state


def trainer_game(kind, module):
    """The trainer jobs' world in ``module`` (the port or the JAX package):
    SingleRoom, or MultiPlayerRoom (2 players, camera_u32) for "players"."""
    if kind == "players":
        return module.MultiPlayerRoom(module.MultiPlayerConfig(**dict(SMALL, obs_type="camera_u32")))
    return module.SingleRoom(module.EnvConfig(**SMALL))


def trainer_run(mesh, job):
    """One train step of ``job`` (kind, trunk, the global carried state)
    over ``mesh``: the gathered rollout phase (feedforward), the gathered
    new state and metrics, and this rank's own params."""
    kind, trunk, global_ts = job
    env = rt.Env(trainer_game(kind, rt), num_envs=B, mesh=mesh)
    cls = ppo_rnn.RecurrentPPOTrainer if kind == "gru" else ppo.PPOTrainer
    tr = cls(env, ppo.PPOConfig(**PPO), hidden=HIDDEN, trunk=trunk, mesh=mesh)
    ts = tr.shard(global_ts)
    out = {}
    if kind != "gru":
        with torch.no_grad():
            env_state, traj, adv, target, aux = tr._rollout_phase(ts, rt.rng.split(ts.key, 3)[1])
        g = lambda x: mesh.gather(x, dim=1).numpy()  # noqa: E731 [T, B/dp] -> [T, B]
        out["roll"] = dict(
            env_state=mesh_lib.gather_env_state(env_state, mesh).to_numpy(),
            **{f: g(getattr(traj, f)) for f in traj._fields}, adv=g(adv), target=g(target),
            aux={k: float(v) for k, v in aux.items()})
    ts2, m = tr.train_step(ts)
    out["state"] = flat(ppo.gather_train_state(ts2, mesh))
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["local"] = {k: v.numpy() for k, v in ts2.params.items()}
    out["mp_index"] = mesh.mp_index
    return out, tr, ts, ts2


def _no_jax():
    assert "jax" not in sys.modules, "a rank imported JAX"


def _capture(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def _two_ranks(jobs, ckpt_dir):
    """Everything of the 2-rank topology: env at dp = 2, the dp = 2
    trainer jobs, checkpoints, the tools and the errors."""
    _no_jax()
    mesh = mesh_lib.make_mesh(dp=2, devices=["cpu", "cpu"])
    out = {"env": env_runs(mesh), "trainers": {}}
    for name, job in jobs.items():
        res, tr, ts, ts2 = trainer_run(mesh, job)
        out["trainers"][name] = res
        if name == "ppo_conv":
            # the train state: a dp = 2 save, restored onto dp = 2,
            # continues as the original
            path = checkpoint.save(os.path.join(ckpt_dir, "ts_dp2"), ts2, {"u": 1}, mesh=mesh)
            back = checkpoint.restore(path, ts, mesh=mesh)
            assert all(np.array_equal(a, b) for a, b in
                       zip(flat(back).values(), flat(ts2).values()))
            want, wm = tr.train_step(ts2)
            got, gm = tr.train_step(back)
            out["ckpt_train_continues"] = (
                all(np.array_equal(a, b) for a, b in zip(flat(got).values(), flat(want).values()))
                and {k: float(v) for k, v in gm.items()} == {k: float(v) for k, v in wm.items()})
    # an env state saved at dp = 2, restored onto dp = 2 and continued
    env = make_env("single_room", mesh)
    state, _ = env.reset(rt.rng.PRNGKey(0))
    state = tail(env, state)
    path = checkpoint.save(os.path.join(ckpt_dir, "env_dp2"), state, {"t": 7}, mesh=mesh)
    restored = checkpoint.restore(path, env.reset(rt.rng.PRNGKey(7))[0], mesh=mesh)
    out["ckpt_env"] = {
        "want": mesh_lib.gather_env_state(tail(env, state), mesh).to_numpy(),
        "got": mesh_lib.gather_env_state(tail(env, restored), mesh).to_numpy(),
    }
    small = ["--device", "cpu", "--num-rays", "16", "--height-px", "16"]
    out["bench_scaling"] = _capture(bench_scaling.main, small + [
        "--envs-per-device", "4", "--steps", "2", "--reset-budget", "1"])
    out["train"] = _capture(train.main, small + [
        "--mesh", "--num-envs", "8", "--updates", "2", "--rollout-steps", "4"])
    errors = {}
    for name, make in {
        "num_envs": lambda: rt.Env(rt.SingleRoom(rt.EnvConfig(**SMALL)), num_envs=7, mesh=mesh),
        "minibatches": lambda: ppo_rnn.RecurrentPPOTrainer(
            rt.Env(rt.SingleRoom(rt.EnvConfig(**SMALL)), num_envs=12, mesh=mesh),
            ppo.PPOConfig(num_minibatches=4)),
        "other_mesh": lambda: ppo.PPOTrainer(
            rt.Env(rt.SingleRoom(rt.EnvConfig(**SMALL)), num_envs=8, device="cpu"),
            mesh=mesh),
    }.items():
        try:
            make()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    os.environ["LOCAL_WORLD_SIZE"] = str(torch.cuda.device_count() + 1)
    try:
        mesh_lib.make_mesh()
        errors["cards"] = None
    except ValueError as e:
        errors["cards"] = str(e)
    out["errors"] = errors
    return out


def _four_ranks(jobs):
    """Everything of the 4-rank topology: env at dp = 4, the dp = 2 x
    mp = 2 trainer jobs and the dry run."""
    _no_jax()
    out = {"env": env_runs(mesh_lib.make_mesh(dp=4, devices=["cpu"] * 4)), "trainers": {}}
    mesh = mesh_lib.make_mesh(dp=2, mp=2, devices=["cpu"] * 4)
    for name, job in jobs.items():
        out["trainers"][name] = trainer_run(mesh, job)[0]
    out["dryrun"] = dryrun.dryrun_multichip(4, ["cpu"] * 4)
    return out


# ---------------------------------------------------------------------------
# The JAX side and the launches
# ---------------------------------------------------------------------------


def jax_env_runs(mesh):
    """``env_runs`` in the JAX package, the states dp-sharded on ``mesh``."""
    import jax

    import raycastworlds_tpu as rcw
    from raycastworlds_tpu.parallel import mesh as jmesh
    from raycastworlds_tpu.parallel.rollout import rollout_random as jrollout
    from raycastworlds_tpu.parallel.rollout import steps_per_second_program as jsps

    out = {}
    for case, (family, config, kw, env_kw) in ENV_CASES.items():
        env = rcw.Env(getattr(rcw, family)(getattr(rcw, config)(**kw)), num_envs=B,
                      jit=False, **env_kw)
        state0, _ = jax.jit(env._reset_impl)(jax.random.PRNGKey(0))
        state0 = jmesh.shard_env_state(state0, mesh)
        state, _ = jax.jit(lambda s, k: jrollout(env, s, k, T))(state0, jax.random.PRNGKey(1))
        out[case] = state
        if case == "single_room":
            out["sps"], acc = jax.jit(jsps(env, 8))(state0, jax.random.PRNGKey(2))
            out["checksum"] = float(acc)
    return out


def jax_trainers(mesh, jobs):
    """Each trainer job on the JAX side: (kind, trunk) -> the carried
    global port state before the step, the JAX rollout phase, the JAX
    state after the step (as the port's flat leaves) and metrics."""
    import jax
    import jax.numpy as jnp

    import raycastworlds_tpu as rcw
    from raycastworlds_tpu.parallel import ppo as jppo
    from raycastworlds_tpu.parallel import ppo_rnn as jrnn
    from raycastworlds_tpu_torch.parallel.params import recurrent_from_flax
    from test_torch_ppo import jax_train_step, np_tree, port_state

    out = {}
    for name, (kind, trunk) in jobs.items():
        jenv = rcw.Env(trainer_game(kind, rcw), num_envs=B, jit=False)
        cfg = jppo.PPOConfig(**PPO)
        if kind == "gru":
            jtr = jrnn.RecurrentPPOTrainer(jenv, cfg, hidden=HIDDEN, trunk=trunk, mesh=mesh)
            jts = jtr.init(jax.random.PRNGKey(0))
            # a carried hidden state that is not zero
            jts = jts._replace(hidden=jnp.asarray(np.tanh(
                np.random.default_rng(5).normal(size=(B, HIDDEN))).astype(np.float32)))
            jts2, jm = jtr.train_step(jts)
            jroll = None

            def port(s):
                st = port_state(s, hidden=torch.from_numpy(np.array(s.hidden)))
                st["params"] = recurrent_from_flax(np_tree(s.params))
                return ppo_rnn.RnnTrainState(**st)
        else:
            jtr = jppo.PPOTrainer(jenv, cfg, mesh=mesh, hidden=HIDDEN, trunk=trunk)
            jts = jtr.init(jax.random.PRNGKey(0))
            jroll, jts2, jm = jax_train_step(jtr, jts)

            def port(s):
                return ppo.TrainState(**port_state(s))
        out[name] = dict(job=(kind, trunk, port(jts)), roll=jroll,
                         state=flat(port(jts2)), metrics={k: float(v) for k, v in jm.items()})
    return out


TWO_JOBS = {"ppo_conv": ("ppo", "conv"), "gru_conv": ("gru", "conv"),
            "ppo_players_mlp": ("players", "mlp")}
FOUR_JOBS = {"ppo_conv_mp2": ("ppo", "conv"), "ppo_mlp_mp2": ("ppo", "mlp")}


@pytest.fixture(scope="module")
def jax_side():
    import jax

    from raycastworlds_tpu.parallel import mesh as jmesh

    dp2 = jmesh.make_mesh(dp=2, devices=jax.devices()[:2])
    dp2mp2 = jmesh.make_mesh(dp=2, mp=2, devices=jax.devices()[:4])
    return dict(env=jax_env_runs(dp2), two=jax_trainers(dp2, TWO_JOBS),
                four=jax_trainers(dp2mp2, FOUR_JOBS))


@pytest.fixture(scope="module")
def one_process():
    return env_runs()


@pytest.fixture(scope="module")
def two(jax_side, tmp_path_factory):
    d = tmp_path_factory.mktemp("two")
    jobs = {k: v["job"] for k, v in jax_side["two"].items()}
    res = mesh_lib.launch(_two_ranks, 2, args=(jobs, str(d)), store=str(d / "store"), threads=1)
    return dict(ranks=res, dir=d)


@pytest.fixture(scope="module")
def four(jax_side, tmp_path_factory):
    d = tmp_path_factory.mktemp("four")
    jobs = {k: v["job"] for k, v in jax_side["four"].items()}
    return dict(ranks=mesh_lib.launch(_four_ranks, 4, args=(jobs,), store=str(d / "store"),
                                      threads=1))


# ---------------------------------------------------------------------------
# Env
# ---------------------------------------------------------------------------


def assert_leaves_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def jax_leaves(state, like):
    return {k: np.asarray(getattr(state, k)) for k in like}


@pytest.mark.parametrize("topology", ["two", "four"])
@pytest.mark.parametrize("case", list(ENV_CASES) + ["sps"])
def test_env_states_match(request, topology, case, one_process, jax_side):
    """Every rank's assembled final state equals the one-process port's and
    the JAX Env's, bit for bit."""
    want = one_process[case]
    assert_leaves_equal(want, jax_leaves(jax_side["env"][case], want))
    for rank in request.getfixturevalue(topology)["ranks"]:
        assert_leaves_equal(rank["env"][case], want)


@pytest.mark.parametrize("topology", ["two", "four"])
def test_checksum_within_rtol(request, topology, one_process, jax_side):
    want = jax_side["env"]["checksum"]
    assert one_process["checksum"] == pytest.approx(want, rel=1e-4)
    for rank in request.getfixturevalue(topology)["ranks"]:
        assert rank["env"]["checksum"] == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("topology", ["two", "four"])
def test_budgeted_step_all_reduces_once(request, topology, one_process):
    """The budgeted reset's one collective a step (the needy counts of the
    dp ranks), counted by the tracer's ``mesh_collectives``; none without
    a process group."""
    assert one_process["budget_collectives"] == 0
    for rank in request.getfixturevalue(topology)["ranks"]:
        assert rank["env"]["budget_collectives"] == T


def test_budget_straddles_a_shard_boundary():
    """The budgeted case does what it is for: at some step more envs need a
    reset than the budget, the budget's first envs lie on both shards of
    dp = 2, and envs stay frozen."""
    env = make_env("random_room_budget", device="cpu")
    state, _ = env.reset(rt.rng.PRNGKey(0))
    key, seen = rt.rng.PRNGKey(1), False
    for _ in range(T):
        key, k = rt.rng.split(key).unbind(0)
        before = state.pending_reset
        res = env.step(state, rt.rng.randint(k, (B,), 0, 4))
        needy = (before | res.done).nonzero().flatten().tolist()
        if len(needy) > BUDGET and {e // (B // 2) for e in needy[:BUDGET]} == {0, 1}:
            seen = bool(res.state.pending_reset.any())
        state = res.state
    assert seen


# ---------------------------------------------------------------------------
# Trainers
# ---------------------------------------------------------------------------


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else float(np.abs(got).max())


def trainer_cases():
    return [("two", k) for k in TWO_JOBS] + [("four", k) for k in FOUR_JOBS]


@pytest.mark.parametrize("topology,job", [c for c in trainer_cases() if c[1].startswith("ppo")])
def test_train_step_rollout_matches_jax(request, topology, job, jax_side):
    """The rollout phase: identical actions, rewards and dones (a flipped
    action at a near tie would be named here), obs within 4 ulp (XLA's FMA
    moves camera_gray), log-probs, values, advantages and targets within
    1e-5, the final env state exact and the rollout's metrics within
    1e-5."""
    jstate, jtraj, jadv, jtarget, jaux = jax_side[topology][job]["roll"]
    for rank in request.getfixturevalue(topology)["ranks"]:
        roll = rank["trainers"][job]["roll"]
        for f in ("action", "reward", "done"):
            diff = np.argwhere(roll[f] != np.asarray(getattr(jtraj, f)))
            assert not diff.size, f"{f} differs at (t, env) {diff.tolist()}"
        if roll["obs"].dtype == np.float32:
            np.testing.assert_array_max_ulp(roll["obs"], np.asarray(jtraj.obs), maxulp=4)
        else:
            np.testing.assert_array_equal(roll["obs"].view(np.uint32), np.asarray(jtraj.obs))
        for f, want in (("log_prob", jtraj.log_prob), ("value", jtraj.value),
                        ("adv", jadv), ("target", jtarget)):
            assert rel_err(roll[f], want) <= 1e-5, f
        assert_leaves_equal(roll["env_state"], jax_leaves(jstate, roll["env_state"]))
        assert sorted(roll["aux"]) == sorted(jaux)
        for k in jaux:
            assert rel_err(roll["aux"][k], float(jaux[k])) <= 1e-5, k
        assert roll["done"].any()


@pytest.mark.parametrize("topology,job", trainer_cases())
def test_train_step_matches_jax(request, topology, job, jax_side):
    """After one train step: metrics within 1e-4 relative, params and Adam
    moments within 1e-4, env state, hidden carry's shape, key and counts
    exact."""
    want = jax_side[topology][job]
    for rank in request.getfixturevalue(topology)["ranks"]:
        got = rank["trainers"][job]
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        for k, v in want["metrics"].items():
            assert rel_err(got["metrics"][k], v) <= 1e-4, k
        state = got["state"]
        assert sorted(state) == sorted(want["state"])
        for k, w in want["state"].items():
            if k.startswith(("params/", "opt_state/mu", "opt_state/nu", "hidden")):
                assert state[k].shape == w.shape, k
                assert rel_err(state[k], w) <= 1e-4, k
            else:
                np.testing.assert_array_equal(state[k], w, err_msg=k)
        assert int(state["opt_state/count"]) == 2 * PPO["num_minibatches"]


@pytest.mark.parametrize("topology,job", trainer_cases())
def test_replicated_params_identical_across_ranks(request, topology, job):
    """Replicated params are bit-identical on every rank, and each mp shard
    on every rank of its mp index."""
    ranks = [r["trainers"][job] for r in request.getfixturevalue(topology)["ranks"]]
    for k in ranks[0]["local"]:
        split = job.startswith("ppo") and ppo.param_shard_dim(k) is not None
        groups = {}
        for r in ranks:
            groups.setdefault(r["mp_index"] if split else 0, []).append(r["local"][k])
        for same in groups.values():
            for v in same[1:]:
                np.testing.assert_array_equal(v, same[0], err_msg=k)


def test_mp_shards_are_halves(four):
    """Under mp = 2 a rank holds half of each split param."""
    r = four["ranks"][1]["trainers"]["ppo_mlp_mp2"]
    for k, v in r["local"].items():
        want = list(r["state"]["params/" + k].shape)
        dim = ppo.param_shard_dim(k)
        if dim is not None:
            want[dim] //= 2
        assert list(v.shape) == want, k


# ---------------------------------------------------------------------------
# Checkpoints, tools, errors
# ---------------------------------------------------------------------------


def test_checkpoint_dp2_save_equals_one_process_save(two, tmp_path):
    """The dp = 2 save of an env state holds the leaves and values of a
    one-process save of the same state; the train state's holds the
    gathered state."""
    env = make_env("single_room", device="cpu")
    state, _ = env.reset(rt.rng.PRNGKey(0))
    path = checkpoint.save(str(tmp_path / "env_one"), tail(env, state), {"t": 7})
    with np.load(path) as one, np.load(two["dir"] / "env_dp2.npz") as dp2:
        assert sorted(one.files) == sorted(dp2.files)
        for k in one.files:
            np.testing.assert_array_equal(dp2[k], one[k], err_msg=k)
    with np.load(two["dir"] / "ts_dp2.npz") as dp2:
        gathered = two["ranks"][0]["trainers"]["ppo_conv"]["state"]
        assert sorted(set(dp2.files) - {"__meta__"}) == sorted(gathered)
        for k, v in gathered.items():
            np.testing.assert_array_equal(dp2[k], v, err_msg=k)


def test_checkpoint_restores_and_continues(two):
    """Restored onto dp = 2 (in the ranks) and onto one process (here), the
    saved state continues bit for bit; a restored train state's next step
    equals the original's."""
    env = make_env("single_room", device="cpu")
    fresh, _ = env.reset(rt.rng.PRNGKey(8))
    single = checkpoint.restore(str(two["dir"] / "env_dp2.npz"), fresh)
    for rank in two["ranks"]:
        want = rank["ckpt_env"]["want"]
        assert_leaves_equal(rank["ckpt_env"]["got"], want)
        assert_leaves_equal(tail(env, single).to_numpy(), want)
        assert rank["ckpt_train_continues"]


def test_bench_scaling_and_train_print_json(two):
    """At 2 ranks ``bench_scaling`` prints one JSON line with the JAX
    script's keys and ``train --mesh`` one line per logged update, from
    rank 0 only."""
    lines = two["ranks"][0]["bench_scaling"].splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert {"metric", "devices", "config", "steps_per_sec_1dev", "steps_per_sec_Ndev",
            "value", "unit", "vs_baseline"} <= set(res)
    assert res["devices"] == 2 and res["config"]["backend"] == "cpu"
    train_lines = two["ranks"][0]["train"].splitlines()
    assert len(train_lines) == 1
    assert json.loads(train_lines[0])["update"] == 2
    assert two["ranks"][1]["bench_scaling"] == two["ranks"][1]["train"] == ""


def test_dryrun_multichip_four_ranks(four):
    for rank in four["ranks"]:
        for name in ("ppo", "gru"):
            assert all(np.isfinite(v) for v in rank["dryrun"][name].values()), name


def test_errors(two):
    errors = two["ranks"][0]["errors"]
    assert "batch 7 not divisible by dp=2" in errors["num_envs"]
    assert "per-shard env count (num_envs / dp) must divide by num_minibatches" in \
        errors["minibatches"]
    assert "must be its env's" in errors["other_mesh"]
    assert "pass devices=" in errors["cards"]


def test_launch_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        mesh_lib.launch(_fail_on_rank_1, 2, store=str(tmp_path / "store"), threads=1)


def _fail_on_rank_1():
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 fails")
    mesh_lib.make_mesh(devices=["cpu", "cpu"]).barrier()
