"""On the card: the port's paths through its kernels, against their plain
backends on the card and against the CPU, bit for bit.

* The golden frames through the crossing kernel; ``top_u32`` card == CPU;
  textured camera_pal8 frames decoding to the camera_u32 frames.
* Every main path (reset + 64 steps of the throughput program at the JAX
  bench rows' widths) through its kernel, launched once per observation
  and no other kernel but, on the camera_rgb and top_rgb paths, the RGB
  conversion once per observation, against each plain backend: identical
  final states and checksums (``analytic``: checksums within 1e-6
  relative, reset frames 99.9% equal).  The configs no kernel takes (continuous headings,
  float64, a 640x640 map) launch none, and equal the CPU run.
* The three PPO rows at full width, and one float32 train step through the
  kernel and through the plain cast.
* Each family's single-env API through each kernel against the plain
  backend, the CPU and row k of an 8-env batch.
* The port bench's rows, PPO rows, ``run_suite`` and ``bench_ppo``'s
  variants.

The card machine has no JAX and this file imports none:
``python -m pytest tests/test_torch_card_paths.py -m cuda --noconftest``.
Kernel launches are read through ``profiling.total``.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch import bench
from raycastworlds_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("crossing_cast", "crossing_render_pal8", "dda_cast", "dda_render_u32", "u32_to_rgb")
RGB_OBS = ("camera_rgb", "top_rgb")
SEED = 0
STEPS = 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    # float32 products in full float32, so that kernel and plain train steps
    # compare at float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def launch_counts() -> dict:
    return {k: profiling.total(f"kernel_launches.{k}") for k in KERNELS}


def assert_launched(before: dict, kernel, n: int, rgb: int = 0) -> None:
    """Since ``before``: ``kernel`` launched ``n`` times, the RGB
    conversion ``rgb`` times (once per observation of an RGB path), no
    other kernel."""
    torch.cuda.synchronize()
    now = launch_counts()
    got = {k: now[k] - before[k] for k in KERNELS}
    want = {k: n if k == kernel else 0 for k in KERNELS}
    want["u32_to_rgb"] += rgb
    assert got == want


def same_state(a, b) -> bool:
    return all(torch.equal(x, b.leaves()[k].to(x.device)) for k, x in a.leaves().items())


def as_i32(x):
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def multi_player_cfg(**kw):
    """The JAX bench row multi_player_2p_4096: 2 players, 64 rays x 64 px."""
    return rt.MultiPlayerConfig(num_rays=64, height_camera_view_pu=64, **kw)


# -- golden frames, top views, textured pal8 ------------------------------

GOLDEN = {
    "single_room": ("SingleRoom", "EnvConfig", dict(num_rays=64, height_camera_view_pu=48)),
    **{f"single_room_{tex}": ("SingleRoom", "EnvConfig", dict(
        num_rays=64, height_camera_view_pu=48, wall_texture=tex, texture_cells=8))
       for tex in ("checker", "brick", "xor")},
    "multi_player": ("MultiPlayerRoom", "MultiPlayerConfig",
                     dict(num_players=2, num_rays=64, height_camera_view_pu=48)),
    "top_view": ("SingleRoom", "EnvConfig", dict(num_rays=32, pu_per_tu=8, obs_type="top_u32")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GOLDEN))
def test_golden_frame_through_the_kernel(cuda_device, name):
    """tests/data/golden_frames.npz's frame (tests/test_golden_images.py's
    rule: the first of seeds 1234, 7, 42, 99 with >= 3 colours after reset
    and actions 2, 0, 3), cast by the crossing kernel."""
    family, config, kw = GOLDEN[name]
    game = getattr(rt, family)(getattr(rt, config)(**kw))
    golden = np.load(os.path.join(ROOT, "tests", "data", "golden_frames.npz"))[name]
    before = launch_counts()["crossing_cast"]
    for seed in (1234, 7, 42, 99):
        state = game.reset_batch(rt.rng.PRNGKey(seed, cuda_device)[None])
        for a in (2, 0, 3):
            state = game.step_batch(state, torch.full(
                (1,) + game.action_shape, a, dtype=torch.int32, device=cuda_device))
        frame = game.observe_batch(state)[0].cpu().numpy()
        if len(np.unique(frame)) >= 3:
            break
    assert launch_counts()["crossing_cast"] > before
    assert frame.dtype == golden.dtype and np.array_equal(frame, golden)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["SingleRoom", "MultiPlayerRoom"])
def test_top_view_card_equals_cpu(cuda_device, family, num_envs=256):
    """top_u32 of SingleRoom (512 rays) and MultiPlayerRoom (the main
    path's config) after a reset and 3 random steps on the card."""
    game = (rt.SingleRoom(rt.EnvConfig(obs_type="top_u32")) if family == "SingleRoom"
            else rt.MultiPlayerRoom(multi_player_cfg(obs_type="top_u32")))
    state = game.reset_batch(rt.rng.split(rt.rng.PRNGKey(SEED, cuda_device), num_envs))
    for q in range(3):
        state = game.step_batch(state, rt.rng.randint(
            rt.rng.PRNGKey(SEED + q, cuda_device), (num_envs,) + game.action_shape, 0, 4))
    got = game.observe_batch(state)
    assert got.shape == (num_envs,) + game.cfg.obs_shape and got.dtype == torch.uint32
    assert torch.equal(as_i32(got).cpu(), as_i32(game.observe_batch(state.to("cpu"))))


@pytest.mark.cuda
@pytest.mark.parametrize("tex", ["checker", "brick", "xor"])
def test_textured_pal8_decodes_to_u32(cuda_device, tex, num_envs=4096):
    """The reference default's textured camera_pal8 frames (the crossing
    kernel's cast) decode through ``cfg.palette_np`` to the camera_u32
    frames of the same states."""
    from raycastworlds_tpu_torch.ops import render

    cfg = rt.EnvConfig(wall_texture=tex, obs_type="camera_pal8",
                       raycast_backend="crossing_kernel_fused")
    game = rt.SingleRoom(cfg)
    state = game.reset_batch(rt.rng.split(rt.rng.PRNGKey(SEED, cuda_device), num_envs))
    for q in range(3):
        state = game.step_batch(state, rt.rng.randint(
            rt.rng.PRNGKey(SEED + q, cuda_device), (num_envs,), 0, 4))
    decoded = render.pal8_to_u32(game.observe_batch(state), cfg.palette_np)
    assert torch.equal(as_i32(decoded), as_i32(game.camera_view_batch(state)))


# -- the main paths --------------------------------------------------------

ROOM = dict(height_tile_map_tu=16, width_tile_map_tu=16, num_rays=256,
            height_camera_view_pu=128)
SMALL = dict(num_rays=64, height_camera_view_pu=64)
# label: (family, config, its keywords, envs, kernel backend, kernel, plain
# backends, reset budget); SingleRoom at the reference default, the other
# families at the widths of the JAX bench rows
MAIN_PATHS = {
    "auto camera_u32": ("SingleRoom", "EnvConfig", {}, 4096, "auto", "crossing_cast",
                        ["crossing"], 0),
    "fused camera_u32": ("SingleRoom", "EnvConfig", {}, 4096, "fused", "dda_render_u32",
                         ["scan"], 0),
    "pallas camera_u32": ("SingleRoom", "EnvConfig", {}, 4096, "pallas", "dda_cast",
                          ["scan"], 0),
    "crossing_kernel_fused camera_pal8": (
        "SingleRoom", "EnvConfig", dict(obs_type="camera_pal8"), 4096, "crossing_kernel_fused",
        "crossing_render_pal8", ["crossing", "crossing_kernel"], 0),
    "auto camera_pal8": ("SingleRoom", "EnvConfig", dict(obs_type="camera_pal8"), 1024,
                         "auto", "crossing_cast", ["crossing"], 0),
    "random_room camera_rgb": ("RandomRoom", "RandomRoomConfig",
                               dict(ROOM, obs_type="camera_rgb"), 8192, "auto",
                               "crossing_cast", ["crossing"], 256),
    "single_room top_rgb": ("SingleRoom", "EnvConfig", dict(pu_per_tu=8, obs_type="top_rgb"),
                            4096, "auto", "crossing_cast", ["crossing"], 0),
    "random_room camera_pal8": ("RandomRoom", "RandomRoomConfig",
                                dict(ROOM, obs_type="camera_pal8"), 8192,
                                "crossing_kernel_fused", "crossing_render_pal8",
                                ["crossing", "crossing_kernel"], 256),
    "maze camera_u32": ("Maze", "MazeConfig", SMALL, 32768, "auto", "crossing_cast",
                        ["crossing"], 512),
    "dynamic_room fused": ("DynamicRoom", "DynamicRoomConfig", SMALL, 8192, "fused",
                           "dda_render_u32", ["scan"], 0),
    "locked_room fused": ("LockedRoom", "LockedRoomConfig", SMALL, 8192, "fused",
                          "dda_render_u32", ["scan"], 0),
    "multi_goal pallas": ("MultiGoalRoom", "MultiGoalConfig", SMALL, 8192, "pallas",
                          "dda_cast", ["scan"], 0),
    "multi_goal analytic": ("MultiGoalRoom", "MultiGoalConfig", SMALL, 8192, "analytic",
                            None, ["crossing"], 0),
    "multi_player camera_u32": ("MultiPlayerRoom", "MultiPlayerConfig", SMALL, 4096, "auto",
                                "crossing_cast", ["crossing"], 0),
    "multi_player block pallas": ("MultiPlayerRoom", "MultiPlayerConfig",
                                  dict(SMALL, player_render="block"), 4096, "pallas",
                                  "dda_cast", ["scan"], 0),
    # the crossing cast, never the pal8 kernel: sprites and textures render
    # after the cast
    "multi_player camera_pal8": ("MultiPlayerRoom", "MultiPlayerConfig",
                                 dict(SMALL, obs_type="camera_pal8"), 4096,
                                 "crossing_kernel_fused", "crossing_cast", ["crossing"], 0),
    "checker camera_u32": ("SingleRoom", "EnvConfig", dict(wall_texture="checker"), 4096,
                           "auto", "crossing_cast", ["crossing"], 0),
    "brick camera_u32": ("SingleRoom", "EnvConfig", dict(wall_texture="brick"), 4096,
                         "pallas", "dda_cast", ["scan"], 0),
    "xor camera_pal8": ("SingleRoom", "EnvConfig",
                        dict(wall_texture="xor", texture_cells=8, obs_type="camera_pal8"), 4096,
                        "crossing_kernel_fused", "crossing_cast", ["crossing"], 0),
}


def run_main_path(game, num_envs, device, reset_budget=0, steps=STEPS):
    """Reset + ``steps`` steps of the throughput program of ``Env(game)``:
    (final state, checksum, the reset's obs, envs the budget reset)."""
    from raycastworlds_tpu_torch.parallel import rollout

    env = rt.Env(game, num_envs=num_envs, device=device, reset_budget=reset_budget)
    resets = torch.zeros((), dtype=torch.int64, device=device)
    step = env.step

    def counted(state, action):
        # the envs needy before the step and not pending after it
        res = step(state, action)
        resets.add_(((state.pending_reset | res.done) & ~res.state.pending_reset).sum())
        return res

    if reset_budget:
        env.step = counted
    state, obs = env.reset(rt.rng.PRNGKey(SEED))
    state, acc = rollout.steps_per_second_program(env, steps)(state, rt.rng.PRNGKey(SEED + 1))
    return state, float(acc), obs, int(resets)


@pytest.mark.cuda
def test_auto_resolves_to_the_crossing_kernel(cuda_device):
    assert rt.EnvConfig().resolved_raycast_backend(cuda_device.type) == "crossing_kernel"


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(MAIN_PATHS))
def test_main_path_kernel_equals_plain(cuda_device, label):
    family, config, kw, num_envs, backend, kernel, plains, budget = MAIN_PATHS[label]
    cfg = getattr(rt, config)(**kw)
    make = lambda b: getattr(rt, family)(dataclasses.replace(cfg, raycast_backend=b))  # noqa: E731
    before = launch_counts()
    state, checksum, obs, resets = run_main_path(make(backend), num_envs, cuda_device, budget)
    # the RGB paths convert each observation once, whatever casts it
    rgb = STEPS + 1 if cfg.obs_type in RGB_OBS else 0
    assert_launched(before, kernel, STEPS + 1, rgb)
    assert tuple(obs.shape) == (num_envs,) + cfg.obs_shape
    assert math.isfinite(checksum)
    if budget:
        assert resets > 0
    for plain in plains:
        p_state, p_sum, p_obs, p_resets = run_main_path(make(plain), num_envs, cuda_device,
                                                        budget)
        assert same_state(p_state, state) and p_resets == resets, plain
        if kernel is None:  # analytic distances are not the crossing's bit for bit
            equal = float((as_i32(p_obs) == as_i32(obs)).to(torch.float32).mean())
            assert abs(p_sum - checksum) <= 1e-6 * abs(p_sum) and equal >= 0.999
        else:
            assert p_sum == checksum, plain


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(continuous_heading=True, turn_increment_au=0.7),
                                dict(dtype="float64")], ids=["continuous", "float64"])
def test_plain_only_config_card_equals_cpu(cuda_device, kw, small=64, steps=16):
    """SingleRoom at the reference default with ``kw``: 4096 envs launch no
    kernel; at ``small`` envs over ``steps`` random steps the card's states
    and frames equal the CPU's."""
    cfg = rt.EnvConfig(**kw)
    before = launch_counts()
    _, checksum, obs, _ = run_main_path(rt.SingleRoom(cfg), 4096, cuda_device)
    assert_launched(before, None, 0)
    assert tuple(obs.shape) == (4096,) + cfg.obs_shape and math.isfinite(checksum)
    envs = [rt.Env(rt.SingleRoom(cfg), num_envs=small, device=d) for d in (cuda_device, "cpu")]
    runs = [e.reset(rt.rng.PRNGKey(SEED)) for e in envs]
    for q in range(steps + 1):
        (gs, go), (cs, co) = runs
        assert same_state(gs.to("cpu"), cs) and torch.equal(as_i32(go).cpu(), as_i32(co)), q
        if q < steps:
            a = rt.rng.randint(rt.rng.PRNGKey(SEED + q), (small,), 0, 4)
            runs = [(r.state, r.obs) for r in (e.step(s, a) for e, (s, _) in zip(envs, runs))]


@pytest.mark.cuda
def test_large_map_takes_the_plain_cast(cuda_device, num_envs=64, steps=4):
    """A 640x640 map's 12,800 packed words pass the kernels' shared-memory
    cap (``KERNEL_MAX_WORDS``, equal to the built library's): ``auto``
    resolves to the plain crossing cast and steps without a launch."""
    from raycastworlds_tpu_torch import config, cuda_build

    assert config.KERNEL_MAX_WORDS == cuda_build.load().rcw_max_smem_words()
    cfg = rt.EnvConfig(height_tile_map_tu=640, width_tile_map_tu=640, **SMALL)
    assert cfg.resolved_raycast_backend("cuda") == "crossing"
    before = launch_counts()
    env = rt.Env(rt.SingleRoom(cfg), num_envs=num_envs, device=cuda_device)
    state, obs = env.reset(rt.rng.PRNGKey(SEED))
    for q in range(steps):
        res = env.step(state, env.sample_action(rt.rng.PRNGKey(SEED + q)))
        state, obs = res.state, res.obs
    assert_launched(before, None, 0)
    assert tuple(obs.shape) == (num_envs, 64, 64)


# -- the PPO rows ----------------------------------------------------------

# The JAX bench's PPO rows: SingleRoom 64 rays x 64 px under ``auto``, the
# mlp trunk of hidden 256, rollout 64, 4 minibatches.  name -> (obs type,
# envs, epochs, recurrent)
PPO_ROWS = {
    "ppo_train_step_mlp_bf16": ("camera_gray", 2048, 2, False),
    "ppo_train_step_throughput": ("camera_gray_u8", 4096, 1, False),
    "ppo_train_step_recurrent_gru": ("camera_gray", 2048, 2, True),
}


def ppo_trainer(row, device, dtype=torch.bfloat16, backend="auto"):
    from raycastworlds_tpu_torch.parallel.ppo import PPOConfig, PPOTrainer
    from raycastworlds_tpu_torch.parallel.ppo_rnn import RecurrentPPOTrainer

    obs, envs, epochs, recurrent = PPO_ROWS[row]
    cfg = rt.EnvConfig(num_rays=64, height_camera_view_pu=64, obs_type=obs,
                       raycast_backend=backend)
    env = rt.Env(rt.SingleRoom(cfg), num_envs=envs, device=device)
    cls = RecurrentPPOTrainer if recurrent else PPOTrainer
    return cls(env, PPOConfig(rollout_steps=STEPS, num_epochs=epochs), hidden=256,
               dtype=dtype, trunk="mlp")


def observations_per_update(trainer) -> int:
    """The observations a train step casts: the rollout's, one a step, and
    the feedforward bootstrap's of the final state (the GRU trainer
    bootstraps from the last step's)."""
    from raycastworlds_tpu_torch.parallel.ppo_rnn import RecurrentPPOTrainer

    return trainer.cfg.rollout_steps + (1 if isinstance(trainer, RecurrentPPOTrainer) else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("row", list(PPO_ROWS))
def test_ppo_row(cuda_device, row, updates=3):
    """``init`` and ``updates`` train steps at full width: the crossing
    cast once per observation and no other kernel, finite metrics and
    params, every param moved, the update counts."""
    trainer = ppo_trainer(row, cuda_device)
    before = launch_counts()
    ts0 = trainer.init(rt.rng.PRNGKey(SEED))
    ts = ts0
    for _ in range(updates):
        ts, metrics = trainer.train_step(ts)
    assert_launched(before, "crossing_cast", 1 + updates * observations_per_update(trainer))
    assert all(math.isfinite(float(v)) for v in metrics.values())
    assert all(bool(torch.isfinite(v).all()) for v in ts.params.values())
    assert not [k for k in ts.params if torch.equal(ts.params[k], ts0.params[k])]
    cfg = trainer.cfg
    assert ts.update_count == updates
    assert ts.opt_state["count"] == updates * cfg.num_epochs * cfg.num_minibatches


@pytest.mark.cuda
def test_ppo_float32_kernel_equals_plain(cuda_device, row="ppo_train_step_mlp_bf16"):
    """One float32 train step through the crossing cast kernel (``auto``)
    and through the plain crossing cast from one key: identical actions,
    rewards, dones and final env states, params within 1e-5 of each
    tensor's largest magnitude."""
    runs = {}
    for backend in ("auto", "crossing"):
        trainer = ppo_trainer(row, cuda_device, torch.float32, backend)
        rollout_phase, kept = trainer._rollout_phase, []
        trainer._rollout_phase = lambda *a: kept.append(rollout_phase(*a)) or kept[-1]
        ts, _ = trainer.train_step(trainer.init(rt.rng.PRNGKey(SEED)))
        traj = kept[-1][1]
        runs[backend] = (ts, (traj.action, traj.reward, traj.done))
    (k_ts, k_traj), (p_ts, p_traj) = runs["auto"], runs["crossing"]
    assert all(torch.equal(a, b) for a, b in zip(k_traj, p_traj))
    assert same_state(k_ts.env_state, p_ts.env_state)
    for k in p_ts.params:
        err = (k_ts.params[k] - p_ts.params[k]).abs().max() / p_ts.params[k].abs().max()
        assert float(err) <= 1e-5, k


# -- the single-env Game API -----------------------------------------------

SINGLE_STEPS = 64
SINGLE_BATCH = 8  # the batch whose row k a single env's run must be
SINGLE_FAMILIES = {
    "single_room": ("SingleRoom", "EnvConfig", {}),
    "random_room": ("RandomRoom", "RandomRoomConfig", ROOM),
    "maze": ("Maze", "MazeConfig", SMALL),
    "multi_goal": ("MultiGoalRoom", "MultiGoalConfig", SMALL),
    "dynamic_room": ("DynamicRoom", "DynamicRoomConfig", SMALL),
    "locked_room": ("LockedRoom", "LockedRoomConfig", SMALL),
    "multi_player 2p": ("MultiPlayerRoom", "MultiPlayerConfig", SMALL),
}
# (label, family, obs type or None, kernel backend, kernel, plain backend)
SINGLE_RUNS = [
    (f"{name} {backend}", name, None, backend, kernel, plain)
    for name in SINGLE_FAMILIES
    for backend, kernel, plain in (("auto", "crossing_cast", "crossing"),
                                   ("pallas", "dda_cast", "scan"))
] + [
    (f"{name} fused {obs}", name, obs, "fused", "dda_render_u32", "scan")
    for name in ("single_room", "dynamic_room", "locked_room")
    for obs in ("camera_u32", "camera_gray")
] + [
    (f"{name} crossing_kernel_fused camera_pal8", name, "camera_pal8",
     "crossing_kernel_fused", "crossing_render_pal8", "crossing")
    for name in ("single_room", "random_room")
]


def facing_goal(state):
    """``state`` with the player (player 0 of MultiPlayerRoom) 0.2 world
    units above its goal tile heading +i, so that the first forward move
    scores and ends the episode."""
    pos, dir_au = state.pos_wu.clone(), state.dir_au.clone()
    at = state.goal_tu.to(pos.dtype) + torch.tensor([-0.2, 0.5], dtype=pos.dtype,
                                                    device=pos.device)
    if pos.dim() > state.goal_tu.dim():   # a player axis
        pos[..., 0, :], dir_au[..., 0] = at, 0
    else:
        pos[...], dir_au[...] = at, 0
    return state.replace(pos_wu=pos, dir_au=dir_au)


def drive_single(game, key, actions):
    """A single-env caller's loop: ``reset_single(key)`` (the player then
    placed by facing_goal), then per action ``step_single``, a re-reset
    from ``state.rng_key`` where the episode ended, and ``observe_single``.
    Returns ({leaf: [T+1, ...]} and "obs", re-resets)."""
    from raycastworlds_tpu_torch.ops import render

    state = facing_goal(game.reset_single(key, key.device))
    states, frames, resets = [state], [game.observe_single(state)], 0
    for a in actions:
        state = game.step_single(state, a)
        if bool(state.done):
            state = game.reset_single(state.rng_key, state.device)
            resets += 1
        states.append(state)
        frames.append(game.observe_single(state))
    run = {k: torch.stack([s.leaves()[k] for s in states]) for k in state.leaves()}
    run["obs"] = torch.stack([render.as_i32(f) for f in frames])
    return run, resets


def drive_batch_row(game, keys, actions, k):
    """``reset_batch(keys)`` (every env placed by facing_goal) and
    ``step_batch`` with every env taking the single run's actions, each
    env re-reset from its ``rng_key`` where its episode ended: {leaf:
    [T+1, ...]} of env ``k``'s states."""
    from raycastworlds_tpu_torch.state import select

    state = facing_goal(game.reset_batch(keys))
    row = torch.tensor([k], device=keys.device)
    rows = [state.index(row).unbatch()]
    for a in actions:
        act = torch.as_tensor(a, dtype=torch.int32, device=keys.device)
        state = game.step_batch(state, act.expand((keys.shape[0],) + tuple(act.shape))
                                .contiguous())
        if bool(state.done.any()):
            state = select(state.done, game.reset_batch(state.rng_key), state)
        rows.append(state.index(row).unbatch())
    return {leaf: torch.stack([r.leaves()[leaf] for r in rows]) for leaf in rows[0].leaves()}


def assert_same_run(got, want) -> None:
    """Every stack of ``want`` equal to ``got``'s, bit for bit, same dtype."""
    assert set(want) <= set(got)
    for k in sorted(want):
        g, w = got[k], want[k].to(got[k].device)
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w), k


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(SINGLE_RUNS)), ids=[r[0] for r in SINGLE_RUNS])
def test_single_env_kernel_equals_plain_cpu_and_batch(cuda_device, i):
    """Reset (the player facing its goal) + 64 seeded steps, the first
    three forward: ``kernel`` once per observation and no other kernel; ==
    the plain backend on the card == the CPU run == row k of an 8-env
    batch with the same keys and actions; every family but MultiGoalRoom
    re-resets."""
    label, name, obs, backend, kernel, plain = SINGLE_RUNS[i]
    family, config, kw = SINGLE_FAMILIES[name]
    cfg = getattr(rt, config)(**(kw if obs is None else dict(kw, obs_type=obs)))
    make = lambda b: getattr(rt, family)(dataclasses.replace(cfg, raycast_backend=b))  # noqa: E731
    game = make(backend)
    shape = game.action_shape
    actions = np.random.default_rng(SEED + 100 + i).choice(
        4, size=(SINGLE_STEPS,) + shape, p=[0.55, 0.05, 0.2, 0.2]).astype(np.int32)
    actions[:3] = 0                       # into the goal: a re-reset
    actions = [a if shape else int(a) for a in actions]
    k = i % SINGLE_BATCH
    keys = rt.rng.split(rt.rng.PRNGKey(SEED + i, cuda_device), SINGLE_BATCH)
    before = launch_counts()
    run, resets = drive_single(game, keys[k], actions)
    assert_launched(before, kernel, SINGLE_STEPS + 1)
    assert tuple(run["obs"].shape[1:]) == cfg.obs_shape
    plain_run, plain_resets = drive_single(make(plain), keys[k], actions)
    assert_same_run(plain_run, run)
    cpu_run, cpu_resets = drive_single(game, keys[k].cpu(), actions)
    assert_same_run(cpu_run, run)
    assert_same_run(run, drive_batch_row(game, keys, actions, k))
    assert resets == plain_resets == cpu_resets
    assert resets > 0 or family == "MultiGoalRoom"


@pytest.mark.cuda
def test_single_env_dda_cast_equals_scan(cuda_device, num=16):
    """``raycast_pallas.cast_rays_pallas`` (one env, the DDA kernel at
    [1, 512]) equals ``cast_rays_scan`` at the reference default on ``num``
    reset states, one launch each."""
    from raycastworlds_tpu_torch.ops import raycast, raycast_pallas

    cfg = rt.EnvConfig(raycast_backend="pallas")
    game = rt.SingleRoom(cfg)
    states = game.reset_batch(rt.rng.split(rt.rng.PRNGKey(SEED + 7, cuda_device), num))
    _, words = game._packed_maps_batch(states)
    for q in range(num):
        s = states.index(torch.tensor([q], device=cuda_device)).unbatch()
        before = launch_counts()
        hits = raycast_pallas.cast_rays_pallas(cfg, words[q], s.pos_wu, s.dir_au)
        assert_launched(before, "dda_cast", 1)
        want = raycast.cast_rays_scan(words[q][None], (cfg.H, cfg.W), s.pos_wu[None],
                                      hits.ray_dirs[None], cfg.dda_steps)
        for g, w in zip(hits[1:], want):
            assert g.shape == w.shape[1:] and torch.equal(g, w[0])


# -- the port bench --------------------------------------------------------

BENCH_STEPS = 8  # and one timed rep: the warm-up and the rep, 2 runs
BACKEND_KERNELS = {"crossing_kernel": "crossing_cast",
                   "crossing_kernel_fused": "crossing_render_pal8",
                   "pallas": "dda_cast", "fused": "dda_render_u32"}
BENCH_CASES = [(name, None) for name, _ in bench.SUITE] + [
    (name, raycast) for name in ("flagship_single_room_4096", "ref_default_res_512x256")
    for raycast in ("pallas", "fused")]


def bench_run(kw, device, raycast=None):
    """``bench.run_one`` of a ``SUITE`` row at BENCH_STEPS steps and one
    rep (under ``raycast`` where given): (its row, its final env state),
    caught by wrapping the bench's ``steps_per_second_program``."""
    kw = dict(kw, steps=BENCH_STEPS, reps=1, **({"raycast": raycast} if raycast else {}))
    program, final = bench.steps_per_second_program, {}

    def catching(env, steps):
        run = program(env, steps)

        def wrapped(state, key):
            final["state"], acc = run(state, key)
            return final["state"], acc

        return wrapped

    bench.steps_per_second_program = catching
    try:
        row = bench.run_one(**kw, device=device)
    finally:
        bench.steps_per_second_program = program
    return row, final["state"]


@pytest.mark.cuda
@pytest.mark.parametrize("name,raycast", BENCH_CASES,
                         ids=[f"{n}-{r or 'auto'}" for n, r in BENCH_CASES])
def test_bench_row_kernel_equals_plain(cuda_device, name, raycast):
    """``auto`` resolved to ``crossing_kernel`` (the row's named backend
    otherwise), its kernel launched once per observation (both players of
    MultiPlayerRoom in one launch), a positive rate and a finite checksum;
    the plain backend from the same keys launches nothing and gives the
    same checksum and final state."""
    kw = dict(bench.SUITE)[name]
    before = launch_counts()
    row, state = bench_run(kw, cuda_device, raycast)
    named = raycast or kw.get("raycast", "auto")
    backend = row["config"]["resolved_backend"]
    assert backend == ("crossing_kernel" if named == "auto" else named)
    kernel = BACKEND_KERNELS[backend]
    rgb = 1 + 2 * BENCH_STEPS if kw.get("obs") in RGB_OBS else 0
    assert_launched(before, kernel, 1 + 2 * BENCH_STEPS, rgb)
    assert row["value"] > 0 and math.isfinite(row["checksum"])
    plain = "scan" if kernel.startswith("dda") else "crossing"
    before = launch_counts()
    p_row, p_state = bench_run(kw, cuda_device, plain)
    assert_launched(before, None, 0, rgb)
    assert p_row["checksum"] == row["checksum"] and same_state(p_state, state)


def ppo_observations(kw) -> int:
    return 1 + 7 * (64 + (1 if kw.get("recurrent") else 2))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", bench.PPO_ROWS, ids=[kw["name"] for kw in bench.PPO_ROWS])
def test_bench_ppo_row(cuda_device, kw, monkeypatch):
    """``run_ppo_row`` at full width: the crossing cast once per
    observation (the reset's, then a warm-up and 6 timed updates) and no
    other kernel, every update's loss finite, a positive rate."""
    from raycastworlds_tpu_torch.parallel.ppo import PPOTrainer
    from raycastworlds_tpu_torch.parallel.ppo_rnn import RecurrentPPOTrainer

    losses = []
    for cls, step in [(c, c.train_step) for c in (PPOTrainer, RecurrentPPOTrainer)]:
        def recording(self, ts, _step=step):
            ts, metrics = _step(self, ts)
            losses.append(float(metrics["loss"]))
            return ts, metrics
        monkeypatch.setattr(cls, "train_step", recording)
    before = launch_counts()
    row = bench.run_ppo_row(**kw, device=cuda_device)
    assert_launched(before, "crossing_cast", ppo_observations(kw))
    assert len(losses) == 7 and all(math.isfinite(x) for x in losses)
    assert row["value"] > 0


@pytest.mark.cuda
def test_bench_run_suite(cuda_device):
    """``run_suite`` over two rows (BENCH_STEPS steps, one rep) and the
    first PPO row: one JSON line, ``summary`` last, no ``error``."""
    rows = [(name, dict(kw, steps=BENCH_STEPS, reps=1)) for name, kw in bench.SUITE[:2]]
    ppo = bench.PPO_ROWS[:1]
    stdout = io.StringIO()
    before = launch_counts()
    with contextlib.redirect_stdout(stdout):
        result = bench.run_suite(rows, ppo, device=cuda_device)
    assert_launched(before, "crossing_cast",
                    len(rows) * (1 + 2 * BENCH_STEPS) + ppo_observations(ppo[0]))
    lines = stdout.getvalue().strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert list(result)[-1] == "summary"
    assert not [r for r in result["rows"] if "error" in r]


@pytest.mark.cuda
@pytest.mark.parametrize("args", [
    [], ["--trunk", "mlp", "--dtype", "bfloat16", "--phases"], ["--recurrent", "--game", "maze"],
    ["--game", "multi_player"], ["--mesh"]], ids=["defaults", "phases", "gru_maze",
                                                  "multi_player", "mesh"])
def test_bench_ppo_cli(cuda_device, args):
    """``python -m raycastworlds_tpu_torch.bench_ppo`` at its default
    widths, 16 rollout steps and one timed update (``--mesh`` at one rank):
    one JSON line on the card with the variant's config."""
    argv = args + ["--rollout-steps", "16", "--updates", "1"]
    out = subprocess.run([sys.executable, "-m", "raycastworlds_tpu_torch.bench_ppo", *argv],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    cfg = row["config"]
    assert row["value"] > 0 and cfg["n_devices"] == 1 and cfg["device"] != "cpu"
    assert cfg["recurrent"] == ("--recurrent" in args)
    assert ("phases" in row) == ("--phases" in args)
