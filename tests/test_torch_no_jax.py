"""The port imports neither JAX nor the JAX package (the GPU machine has no
JAX).  Checked in a fresh interpreter, since the test process imports both."""

import subprocess
import sys

_PROBE = """
import sys
import raycastworlds_tpu_torch as rt
import raycastworlds_tpu_torch.cuda_build
import raycastworlds_tpu_torch.ops.flood
import raycastworlds_tpu_torch.ops.raycast_analytic
import raycastworlds_tpu_torch.ops.raycast_crossing_kernel
import raycastworlds_tpu_torch.ops.raycast_pallas
import raycastworlds_tpu_torch.ops.render_fused
import raycastworlds_tpu_torch.ops.topview
import raycastworlds_tpu_torch.models.multi_player
import raycastworlds_tpu_torch.parallel.rollout
import raycastworlds_tpu_torch.parallel.params
import raycastworlds_tpu_torch.train
import raycastworlds_tpu_torch.utils.checkpoint
import raycastworlds_tpu_torch.utils.webviewer
from raycastworlds_tpu_torch import bench, bench_ppo, bench_scaling, dryrun
from raycastworlds_tpu_torch.parallel import mesh as mesh_lib, ppo, ppo_rnn
for backend in ("auto", "fused"):
    cfg = rt.EnvConfig(num_rays=8, height_camera_view_pu=8, raycast_backend=backend)
    env = rt.Env(rt.SingleRoom(cfg), num_envs=2, device="cpu")
    state, obs = env.reset(rt.rng.PRNGKey(0))
    env.step(state, env.sample_action(rt.rng.PRNGKey(1)))
small = dict(num_rays=8, height_camera_view_pu=8)
for kw in (dict(wall_texture="xor", obs_type="camera_pal8"),
           dict(continuous_heading=True, turn_increment_au=0.7),
           dict(dtype="float64", obs_type="depth")):
    env = rt.Env(rt.SingleRoom(rt.EnvConfig(**small, **kw)), num_envs=2, device="cpu")
    state, obs = env.reset(rt.rng.PRNGKey(0))
    env.step(state, env.sample_action(rt.rng.PRNGKey(1)))
for game in (rt.RandomRoom(rt.RandomRoomConfig(**small)), rt.Maze(rt.MazeConfig(**small)),
             rt.MultiGoalRoom(rt.MultiGoalConfig(**small, raycast_backend="analytic")),
             rt.DynamicRoom(rt.DynamicRoomConfig(**small)),
             rt.LockedRoom(rt.LockedRoomConfig(**small))):
    env = rt.Env(game, num_envs=2, reset_budget=1, device="cpu")
    state, obs = env.reset(rt.rng.PRNGKey(0))
    env.step(state, env.sample_action(rt.rng.PRNGKey(1)))
for obs_type in ("camera_u32", "top_u32"):
    cfg = rt.MultiPlayerConfig(num_rays=8, height_camera_view_pu=8, pu_per_tu=4,
                               obs_type=obs_type)
    env = rt.Env(rt.MultiPlayerRoom(cfg), num_envs=2, device="cpu")
    state, obs = env.reset(rt.rng.PRNGKey(0))
    env.step(state, env.sample_action(rt.rng.PRNGKey(1)))
env = rt.Env(rt.SingleRoom(rt.EnvConfig(**small, obs_type="camera_gray")), num_envs=2,
             device="cpu")
cfg = ppo.PPOConfig(rollout_steps=2, num_epochs=1, num_minibatches=2)
for trainer in (ppo.PPOTrainer(env, cfg, hidden=8, trunk="mlp"),
                ppo_rnn.RecurrentPPOTrainer(env, cfg, hidden=8)):
    trainer.train_step(trainer.init(rt.rng.PRNGKey(0)))
mesh = mesh_lib.make_mesh(devices=["cpu"])
env = rt.Env(rt.SingleRoom(rt.EnvConfig(**small, obs_type="camera_gray")), num_envs=2,
             mesh=mesh, reset_budget=1)
for trainer in (ppo.PPOTrainer(env, cfg, hidden=8, trunk="mlp", mesh=mesh),
                ppo_rnn.RecurrentPPOTrainer(env, cfg, hidden=8, mesh=mesh)):
    trainer.train_step(trainer.init(rt.rng.PRNGKey(0)))
dryrun.dryrun_multichip(1, ["cpu"], num_rays=8, height_px=8)
bench_scaling.build_env(num_envs=2, num_rays=8, height_px=8, device="cpu", mesh=mesh)
import contextlib, io, tempfile
import numpy as np
import torch
from raycastworlds_tpu_torch import gym_compat, wrappers
from raycastworlds_tpu_torch.utils import debug, profiling, video, viewer, webviewer
from raycastworlds_tpu_torch.examples import (
    multi_player_demo, profile_ppo, profile_step, rollout_demo)
game = rt.SingleRoom(rt.EnvConfig(**small))
g = rt.GymAdapter(game, max_episode_steps=2, device="cpu")
g.reset(seed=0)
g.step(0)
g.render()
v = rt.GymVectorAdapter(game, num_envs=2, final_observation=True, device="cpu")
v.reset(seed=0)
v.step(np.zeros(2, np.int64))
v.render()
env = rt.Env(game, num_envs=2, device="cpu")
for w in (rt.FrameStack(env, 2), rt.ObsTransform(env, wrappers.downsample2x)):
    s, _ = w.reset(rt.rng.PRNGKey(0))
    w.step(s, torch.zeros(2, dtype=torch.int32))
state, _ = env.reset(rt.rng.PRNGKey(0))
debug.validate_state(env.cfg, state)
debug.checked(env.step)(state, torch.zeros(2, dtype=torch.int32))[0].throw()
profiling.device_metrics(state.done[None], state.reward[None])
video.record_episode(env, rt.rng.PRNGKey(0), steps=1)
viewer.play(env, out=io.StringIO(), window=False)
webviewer.WebPlaySession(env).handle_key("w")
rt.tile_map(state)
rt.rng.fold_in(rt.rng.PRNGKey(0), 1)
from raycastworlds_tpu_torch.models import MultiPlayerRoom, MultiPlayerConfig
from raycastworlds_tpu_torch.parallel import PPOTrainer, rollout_random
from raycastworlds_tpu_torch.ops import collision, raycast_analytic, raycast_pallas
one = rt.SingleRoom(rt.EnvConfig(**small))
s = one.step_single(one.reset_single(rt.rng.PRNGKey(0), "cpu"), 0)
one.observe_from_hits_single(s, one.cast_single(s))
one.observe_single(s), one.top_view_single(s), one.camera_view_single(s)
raycast_pallas.cast_rays_pallas(one.cfg, s.wall_words, s.pos_wu, s.dir_au)
raycast_analytic.cast_rays_analytic(one.cfg, s.goal_tu, s.pos_wu, s.dir_au)
collision.is_player_colliding(s.wall_map, s.pos_wu, 0.125)
mp = MultiPlayerRoom(MultiPlayerConfig(**small))
mp.observe_single(mp.step_single(mp.reset_single(rt.rng.PRNGKey(0), "cpu"), torch.zeros(2)))
rt.colors.rgb_to_u32(rt.colors.u32_to_rgb(rt.colors.PALETTE_NP))
rt.config.replace(one.cfg, num_rays=4)
tiny = ["--device", "cpu", "--num-rays", "8", "--height-px", "8"]
with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()):
    rollout_demo.main(tiny + ["--num-envs", "2", "--chunk-steps", "1", "--chunks", "1"])
    multi_player_demo.main(tiny + ["--num-envs", "1", "--steps", "1", "--out", d])
    profile_step.main(tiny + ["--num-envs", "2", "--steps", "1", "--trace-dir", d + "/t"])
    profile_ppo.main(tiny + ["--num-envs", "2", "--rollout-steps", "2", "--hidden", "8",
                             "--trunk", "mlp", "--reps", "1"])
    bench.main(tiny + ["--num-envs", "2", "--steps", "1", "--reps", "1"])
    bench_ppo.main(tiny + ["--num-envs", "2", "--rollout-steps", "2", "--updates", "1",
                           "--hidden", "8", "--trunk", "mlp"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "raycastworlds_tpu"))
print(",".join(bad))
"""


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port imported: {out.stdout.strip()}"
