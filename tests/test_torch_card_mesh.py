"""On the card: the mesh (``parallel/mesh.py``) at the PPO rows' widths in
float32 with TF32 off (SingleRoom 64 rays x 64 px camera_gray, mlp hidden
256, rollout 64, 4 minibatches, 2 epochs).

* One rank under NCCL (dp = 1, 2048 envs): the feedforward and GRU
  trainers with a mesh equal the same trainers without one (identical
  rollouts, params within 1e-5), and the mesh's all-reduces ran
  (``mesh_collectives``).
* Two ranks sharing the card under gloo on CUDA tensors (dp = 2, 4096
  global envs): reset + 16 steps, and the budgeted RandomRoom (8192 envs,
  budget 256, every episode truncated at step 8 so that the budget walks
  across the shard boundary), assembled, equal the one-process card run
  bit for bit; one feedforward and one GRU train step whose rollouts are
  the one-process run's, with the params bit-identical on both ranks.
* Four ranks (dp = 2 x mp = 2) take one feedforward step with the rollout
  cut to 16 steps: its rollout equals the dp = 2 run's from the same
  state, its first minibatch's loss and gathered gradients are within
  1e-4 of dp = 2's, and ranks that hold the same parameter block hold the
  same bits.

Every run launches ``crossing_cast`` once per observation and no other
kernel but, on the budgeted RandomRoom's RGB frames, ``u32_to_rgb`` once
per observation.  The ranks are this module's functions (spawned; they
import no JAX):
``python -m pytest tests/test_torch_card_mesh.py -m cuda --noconftest``.
"""

import math
import sys

import numpy as np
import pytest
import torch

import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch.parallel import mesh as mesh_lib
from raycastworlds_tpu_torch.utils import profiling
from test_torch_card_paths import STEPS, assert_launched, launch_counts, observations_per_update

SEED = 0
ENVS = 4096            # global envs of the two- and four-rank runs
ONE_RANK_ENVS = 2048   # the one-rank NCCL run's
SHORT_ROLLOUT = 16     # the dp = 2 x mp = 2 step's rollout
ENV_STEPS = 16
BUDGET_STEPS = 32      # the budget's 256 resets a step cross env 4096 at step 24


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from raycastworlds_tpu_torch import cuda_build

    tf32_off()
    cuda_build.load()  # built once, before any rank starts
    return torch.device("cuda", 0)


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def env_task(task, device, mesh=None) -> dict:
    """Reset + the throughput program (ENV_STEPS steps of SingleRoom for
    "env", BUDGET_STEPS of the budgeted RandomRoom for "budget"): the
    assembled final state's leaves (numpy) and the checksum."""
    from raycastworlds_tpu_torch.parallel import rollout

    device = None if mesh else device
    if task == "env":
        cfg = rt.EnvConfig(num_rays=64, height_camera_view_pu=64, obs_type="camera_gray")
        env, steps = rt.Env(rt.SingleRoom(cfg), num_envs=ENVS, device=device, mesh=mesh), ENV_STEPS
    else:
        cfg = rt.RandomRoomConfig(height_tile_map_tu=16, width_tile_map_tu=16, num_rays=256,
                                  height_camera_view_pu=128, obs_type="camera_rgb",
                                  max_episode_steps=8)
        env = rt.Env(rt.RandomRoom(cfg), num_envs=8192, reset_budget=256, device=device,
                     mesh=mesh)
        steps = BUDGET_STEPS
    before = launch_counts()
    state, _ = env.reset(rt.rng.PRNGKey(SEED))
    state, acc = rollout.steps_per_second_program(env, steps)(state, rt.rng.PRNGKey(SEED + 1))
    checksum = float(acc)
    # the budgeted RandomRoom's camera_rgb converts each observation once
    assert_launched(before, "crossing_cast", steps + 1, steps + 1 if task == "budget" else 0)
    if mesh is not None:
        state = mesh_lib.gather_env_state(state, mesh)
    return dict(state=state.to_numpy(), checksum=checksum)


def first_minibatch(first: dict, monkeypatch):
    """Make the feedforward update record into ``first`` its first
    minibatch's loss (this rank's part) and its gradients as the optimizer
    clips them (averaged over dp; this rank's mp shards)."""
    from raycastworlds_tpu_torch.parallel import ppo

    clip, loss_fn = ppo.clip_by_global_norm, ppo.ppo_loss

    def clip_first(grads, *args):
        first.setdefault("grads", [g.detach().clone() for g in grads])
        return clip(grads, *args)

    def loss_first(*args):
        out = loss_fn(*args)
        first.setdefault("loss", out[0].detach().clone())
        return out

    monkeypatch.setattr(ppo, "clip_by_global_norm", clip_first)
    monkeypatch.setattr(ppo, "ppo_loss", loss_first)


def train_task(task, device, num_envs=ENVS, mesh=None) -> dict:
    """``init`` and one train step of ``task``'s trainer ("ppo" and "gru"
    at the rows' widths, "ppo16" the feedforward one at SHORT_ROLLOUT):
    the assembled actions, rewards (feedforward), dones and final env state
    of its rollout, the assembled params after it (numpy), this rank's
    params and the metrics; for "ppo16" also the first minibatch's global
    loss and assembled gradients."""
    from raycastworlds_tpu_torch.parallel.ppo import PPOConfig, PPOTrainer, gather_params
    from raycastworlds_tpu_torch.parallel.ppo_rnn import RecurrentPPOTrainer

    cfg = rt.EnvConfig(num_rays=64, height_camera_view_pu=64, obs_type="camera_gray")
    env = rt.Env(rt.SingleRoom(cfg), num_envs=num_envs, device=None if mesh else device,
                 mesh=mesh)
    cls = RecurrentPPOTrainer if task == "gru" else PPOTrainer
    trainer = cls(env, PPOConfig(rollout_steps=SHORT_ROLLOUT if task == "ppo16" else STEPS,
                                 num_epochs=2),
                  hidden=256, dtype=torch.float32, trunk="mlp", mesh=mesh)
    rollout_phase, kept = trainer._rollout_phase, []
    trainer._rollout_phase = lambda *a: kept.append(rollout_phase(*a)) or kept[-1]
    before = launch_counts()
    ts0 = trainer.init(rt.rng.PRNGKey(SEED))
    first = {}
    with pytest.MonkeyPatch.context() as m:
        if task == "ppo16":
            first_minibatch(first, m)
        ts, metrics = trainer.train_step(ts0)
    assert_launched(before, "crossing_cast", 1 + observations_per_update(trainer))
    if task == "gru":
        env_state, _, data, _ = kept[-1]
        roll = {"action": data["action"], "done": data["done"]}
    else:
        env_state, traj = kept[-1][:2]
        roll = {"action": traj.action, "reward": traj.reward, "done": traj.done}
    gather = (lambda x: x) if mesh is None else (lambda x: mesh.gather(x, dim=1))  # noqa: E731
    if mesh is not None:
        env_state = mesh_lib.gather_env_state(env_state, mesh)
    params = ts.params if mesh is None or task == "gru" else gather_params(ts.params, mesh)
    out = dict(
        roll={k: gather(v).cpu().numpy() for k, v in roll.items()},
        env_state=env_state.to_numpy(),
        params={k: v.cpu().numpy() for k, v in params.items()},
        local={k: v.cpu().numpy() for k, v in ts.params.items()},
        metrics={k: float(v) for k, v in metrics.items()},
    )
    assert all(math.isfinite(v) for v in out["metrics"].values())
    assert not [k for k in ts.params if torch.equal(ts.params[k], ts0.params[k])]
    if first:
        grads, loss = dict(zip(ts.params, first["grads"])), first["loss"]
        if mesh is not None:
            grads, loss = gather_params(grads, mesh), mesh.mean(loss)
        out["first_grads"] = {k: v.cpu().numpy() for k, v in grads.items()}
        out["first_loss"] = float(loss)
    return out


def _rank(dp, mp, tasks) -> dict:
    """One rank (started by ``mesh.launch`` under gloo, every rank on
    ``cuda:0``): the (dp, mp) mesh, then each task's result."""
    from raycastworlds_tpu_torch import cuda_build

    assert not any(m.split(".")[0] == "jax" for m in sys.modules), "a rank imported JAX"
    tf32_off()
    cuda_build.load()
    world = torch.distributed.get_world_size()
    mesh = mesh_lib.make_mesh(dp=dp, mp=mp, devices=["cuda:0"] * world)
    out = {"mp_index": mesh.mp_index}
    for task in tasks:
        out[task] = env_task(task, None, mesh) if task in ("env", "budget") else train_task(
            task, None, ENVS, mesh)
    return out


def params_rel_err(got: dict, want: dict) -> float:
    """The largest difference of any param over that param's largest
    magnitude."""
    return max(float(np.abs(got[k].astype(np.float64) - want[k]).max() / np.abs(want[k]).max())
               for k in want)


def assert_same_rollout(got, want) -> None:
    for k, w in want["roll"].items():
        np.testing.assert_array_equal(got["roll"][k], w, err_msg=k)
    assert got["env_state"].keys() == want["env_state"].keys()
    for k, w in want["env_state"].items():
        np.testing.assert_array_equal(got["env_state"][k], w, err_msg=k)


@pytest.fixture(scope="module")
def two(card, tmp_path_factory):
    """The one-process card runs, and the two ranks' runs."""
    ref = {task: env_task(task, card) for task in ("env", "budget")}
    ref.update({task: train_task(task, card) for task in ("ppo", "gru")})
    store = tmp_path_factory.mktemp("two") / "store"
    ranks = mesh_lib.launch(_rank, 2, backend="gloo",
                            args=(2, 1, ("env", "budget", "ppo", "gru", "ppo16")),
                            store=str(store))
    return ref, ranks


@pytest.fixture(scope="module")
def four(card, tmp_path_factory):
    store = tmp_path_factory.mktemp("four") / "store"
    return mesh_lib.launch(_rank, 4, backend="gloo", args=(2, 2, ("ppo16",)), store=str(store))


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["ppo", "gru"])
def test_one_rank_nccl_equals_no_mesh(card, task, tmp_path):
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/nccl", world_size=1,
                            rank=0)
    try:
        mesh = mesh_lib.make_mesh(dp=1, devices=[card])
        plain = train_task(task, card, ONE_RANK_ENVS)
        before = profiling.total("mesh_collectives")
        meshed = train_task(task, card, ONE_RANK_ENVS, mesh)
        assert profiling.total("mesh_collectives") > before
    finally:
        dist.destroy_process_group()
    assert_same_rollout(meshed, plain)
    assert params_rel_err(meshed["params"], plain["params"]) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["env", "budget"])
def test_two_ranks_env_equals_one_process(two, task):
    ref, ranks = two
    for rank in ranks:
        assert rank[task]["state"].keys() == ref[task]["state"].keys()
        for k, w in ref[task]["state"].items():
            np.testing.assert_array_equal(rank[task]["state"][k], w, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["ppo", "gru"])
def test_two_ranks_train_step(two, task):
    """The rollout is the one-process run's; the params are bit-identical
    on both ranks."""
    ref, ranks = two
    for rank in ranks:
        assert_same_rollout(rank[task], ref[task])
    for k, v in ranks[0][task]["local"].items():
        np.testing.assert_array_equal(ranks[1][task]["local"][k], v, err_msg=k)


@pytest.mark.cuda
def test_four_ranks_dp2_mp2(two, four):
    from raycastworlds_tpu_torch.parallel.ppo import param_shard_dim

    mp_run, dp_run = four[0]["ppo16"], two[1][0]["ppo16"]
    assert_same_rollout(mp_run, dp_run)
    assert params_rel_err(mp_run["first_grads"], dp_run["first_grads"]) <= 1e-4
    assert abs(mp_run["first_loss"] - dp_run["first_loss"]) <= 1e-4 * abs(dp_run["first_loss"])
    for k in mp_run["local"]:
        blocks = {}  # a split param's block per mp index; the others whole
        for x in four:
            blocks.setdefault(x["mp_index"] if param_shard_dim(k) is not None else 0,
                              []).append(x["ppo16"]["local"][k])
        assert all(np.array_equal(v, b[0]) for b in blocks.values() for v in b), k
