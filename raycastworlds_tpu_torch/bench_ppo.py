"""End-to-end training throughput: the PPO learner in the loop (BASELINE
config 5's shape, one host).

    python -m raycastworlds_tpu_torch.bench_ppo --trunk mlp --dtype bfloat16 --phases
    python -m raycastworlds_tpu_torch.bench_ppo --device cpu --num-envs 8 --updates 2
    torchrun --nproc-per-node 4 -m raycastworlds_tpu_torch.bench_ppo --mesh

The port of the JAX package's ``bench_ppo.py``: env-steps/s through the
whole train step (the rollout with policy inference per step, GAE, the
clipped PPO epochs), what an RL user sustains.  One warm-up update, then
``--updates`` timed ones ending on the host read of the last loss; prints
one JSON line with the JAX script's keys.  ``--phases`` also times the
feedforward trainer's rollout and update phases alone (median of 3 after a
warm-up, each ending on a host read).

Runs on the CUDA device unless ``--device`` names another (no fallback to
the CPU).  ``--mesh`` trains data-parallel over every rank torchrun started
(``--num-envs`` is the global batch): one card per rank under NCCL, or
every rank on ``--device`` under gloo; only rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import Env, EnvConfig, Maze, MazeConfig, MultiPlayerConfig, MultiPlayerRoom, SingleRoom, rng
from .bench import device_name
from .parallel.ppo import PPOConfig, PPOTrainer
from .parallel.ppo_rnn import RecurrentPPOTrainer
from .train import make_mesh


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=2048)
    p.add_argument("--rollout-steps", type=int, default=64)
    p.add_argument("--updates", type=int, default=8, help="timed updates")
    p.add_argument("--num-rays", type=int, default=64)
    p.add_argument("--height-px", type=int, default=64)
    p.add_argument("--obs", type=str, default="camera_gray")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="network compute dtype (params stay float32)")
    p.add_argument("--trunk", type=str, default="conv",
                   choices=["conv", "patch", "mlp"],
                   help="image trunk: overlapping convs, 8x8 patch embed, "
                        "or flat pixel MLP (max throughput)")
    p.add_argument("--game", type=str, default="single_room",
                   choices=["single_room", "multi_player", "maze"])
    p.add_argument("--num-players", type=int, default=2,
                   help="players per env (multi_player; one shared policy)")
    p.add_argument("--recurrent", action="store_true",
                   help="GRU actor-critic (parallel/ppo_rnn.py)")
    p.add_argument("--epochs", type=int, default=0,
                   help="override PPO epochs (0 = PPOConfig default)")
    p.add_argument("--phases", action="store_true",
                   help="additionally time rollout/update phases separately "
                        "(feedforward trainer only)")
    p.add_argument("--mesh", action="store_true",
                   help="data-parallel over every rank torchrun started (dp)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device; with --mesh, "
                        "every rank's)")
    return p.parse_args(argv)


def make_trainer(args: argparse.Namespace, mesh=None):
    kw = dict(num_rays=args.num_rays, height_camera_view_pu=args.height_px,
              obs_type=args.obs)
    if args.game == "multi_player":
        game = MultiPlayerRoom(MultiPlayerConfig(num_players=args.num_players, **kw))
    elif args.game == "maze":
        game = Maze(MazeConfig(height_tile_map_tu=17, width_tile_map_tu=17, **kw))
    else:
        game = SingleRoom(EnvConfig(**kw))
    env = Env(game, num_envs=args.num_envs, device=None if mesh else args.device, mesh=mesh)
    ppo_cfg = PPOConfig(rollout_steps=args.rollout_steps)
    if args.epochs:
        ppo_cfg = ppo_cfg._replace(num_epochs=args.epochs)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    cls = RecurrentPPOTrainer if args.recurrent else PPOTrainer
    return cls(env, ppo_cfg, hidden=args.hidden, dtype=dtype, trunk=args.trunk)


def time_phases(trainer: PPOTrainer, ts) -> dict:
    """The rollout and update phases' ms, each the median of 3 after a
    warm-up, each call ending on the host read of one of its metrics."""
    k = rng.PRNGKey(1, trainer.env.device)

    def roll(s, k):
        with torch.no_grad():
            return trainer._rollout_phase(s, k)[4]["reward_per_step"]

    def upd(p, o, k, tr, a, tg):
        return trainer._update_phase(p, o, k, tr, a, tg)[2]["loss"]

    with torch.no_grad():
        _, traj, adv, target, _ = trainer._rollout_phase(ts, k)

    def t_of(fn, *a, reps=3):
        float(fn(*a))
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(fn(*a))
            times.append(time.perf_counter() - t0)
        return sorted(times)[len(times) // 2]

    per = trainer.env.num_envs * trainer.cfg.rollout_steps
    phases = {
        "rollout_ms": round(1e3 * t_of(roll, ts, k), 2),
        "update_ms": round(
            1e3 * t_of(upd, ts.params, ts.opt_state, k, traj, adv, target), 2),
    }
    phases["rollout_sps"] = round(per / (phases["rollout_ms"] / 1e3))
    phases["update_sps"] = round(per / (phases["update_ms"] / 1e3))
    return phases


def main(argv=None) -> dict:
    args = parse_args(argv)
    joins = args.mesh and not torch.distributed.is_initialized()
    mesh = make_mesh(args)
    try:
        trainer = make_trainer(args, mesh)
        ts = trainer.init(rng.PRNGKey(0))
        ts, metrics = trainer.train_step(ts)  # warm-up
        float(metrics["loss"])

        t0 = time.perf_counter()
        for _ in range(args.updates):
            ts, metrics = trainer.train_step(ts)
        float(metrics["loss"])
        dt = time.perf_counter() - t0

        sps = args.num_envs * args.rollout_steps * args.updates / dt
        phases = (time_phases(trainer, ts)
                  if args.phases and not args.recurrent else None)
        world = (torch.distributed.get_world_size()
                 if args.mesh and torch.distributed.is_initialized() else 1)
    finally:
        if joins and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()

    out = {
        "metric": "ppo_env_steps_per_sec",
        "value": round(sps, 1),
        "unit": "steps/s (through full PPO train step)",
        "vs_baseline": round(sps / 1e7, 4),
        "config": {
            "game": args.game,
            "num_players": args.num_players if args.game == "multi_player" else 1,
            "num_envs": args.num_envs,
            "rollout_steps": args.rollout_steps,
            "obs": args.obs,
            "hidden": args.hidden,
            "dtype": args.dtype,
            "trunk": args.trunk,
            "recurrent": args.recurrent,
            "num_epochs": trainer.cfg.num_epochs,
            "device": device_name(trainer.env.device),
            "n_devices": world,
        },
        "seconds": round(dt, 3),
    }
    if phases:
        out["phases"] = phases
    if mesh is None or mesh.rank == 0:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
