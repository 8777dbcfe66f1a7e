"""Train a PPO agent on batched raycast worlds (BASELINE config 5's shape).

    python -m raycastworlds_tpu_torch.train --num-envs 1024 --updates 200
    python -m raycastworlds_tpu_torch.train --device cpu --num-envs 8 --updates 2
    torchrun --nproc-per-node 4 -m raycastworlds_tpu_torch.train --mesh --num-envs 4096

The port of the JAX package's ``examples/train_ppo.py``: the same flags and
the same JSON line per logged update (every 10 updates and the last), less
``--backend``, plus ``--device`` (the CUDA device by default; there is no
fallback to the CPU).  ``--mesh`` trains data-parallel over every rank that
torchrun started (dp = the world size; ``--num-envs`` is the global batch):
one card per rank under NCCL by default, or every rank on ``--device``
under gloo (``cpu``, or one shared card); only rank 0 prints.
"""

from __future__ import annotations

import argparse
import json

import torch

from . import (
    EnvConfig,
    Env,
    LockedRoom,
    LockedRoomConfig,
    Maze,
    MazeConfig,
    MultiPlayerConfig,
    MultiPlayerRoom,
    RandomRoom,
    RandomRoomConfig,
    SingleRoom,
    rng,
)
from .parallel import mesh as mesh_lib
from .parallel.ppo import PPOConfig, PPOTrainer
from .parallel.ppo_rnn import RecurrentPPOTrainer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--game",
                   choices=["single_room", "random_room", "maze",
                            "multi_player", "locked_room"],
                   default="single_room")
    p.add_argument("--num-players", type=int, default=2,
                   help="players per env (multi_player; one shared policy)")
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--map-h", type=int, default=0, help="tile-map height override")
    p.add_argument("--map-w", type=int, default=0, help="tile-map width override")
    p.add_argument("--updates", type=int, default=100)
    p.add_argument("--rollout-steps", type=int, default=64)
    p.add_argument("--num-rays", type=int, default=32)
    p.add_argument("--height-px", type=int, default=32)
    p.add_argument("--obs", type=str, default="camera_gray")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--epochs", type=int, default=0,
                   help="override PPO epochs (0 = PPOConfig default)")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-episode-steps", type=int, default=0)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--trunk", type=str, default="conv",
                   choices=["conv", "patch", "mlp"])
    p.add_argument("--recurrent", action="store_true",
                   help="GRU actor-critic (parallel/ppo_rnn.py) for "
                        "partially observable worlds")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device; with --mesh, "
                        "every rank's)")
    p.add_argument("--mesh", action="store_true",
                   help="data-parallel over every rank torchrun started (dp)")
    return p.parse_args(argv)


def make_mesh(args: argparse.Namespace):
    """The dp mesh of ``--mesh`` over the process group (joined from
    torchrun's environment where there is none yet), or None."""
    if not args.mesh:
        return None
    mesh_lib.initialize_distributed(backend="nccl" if args.device is None else "gloo")
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    return mesh_lib.make_mesh(devices=None if args.device is None else [args.device] * world)


def make_trainer(args: argparse.Namespace, mesh=None):
    kw = dict(num_rays=args.num_rays, height_camera_view_pu=args.height_px,
              obs_type=args.obs, max_episode_steps=args.max_episode_steps)
    if args.map_h:
        kw["height_tile_map_tu"] = args.map_h
    if args.map_w:
        kw["width_tile_map_tu"] = args.map_w
    if args.game == "single_room":
        game = SingleRoom(EnvConfig(**kw))
    elif args.game == "random_room":
        game = RandomRoom(RandomRoomConfig(
            height_tile_map_tu=16, width_tile_map_tu=16, **kw))
    elif args.game == "multi_player":
        game = MultiPlayerRoom(MultiPlayerConfig(num_players=args.num_players, **kw))
    elif args.game == "locked_room":
        game = LockedRoom(LockedRoomConfig(**kw))
    else:
        game = Maze(MazeConfig(**kw))
    env = Env(game, num_envs=args.num_envs, device=None if mesh else args.device, mesh=mesh)
    ppo_cfg = PPOConfig(rollout_steps=args.rollout_steps, lr=args.lr)
    if args.epochs:
        ppo_cfg = ppo_cfg._replace(num_epochs=args.epochs)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    cls = RecurrentPPOTrainer if args.recurrent else PPOTrainer
    return cls(env, ppo_cfg, hidden=args.hidden, dtype=dtype, trunk=args.trunk)


def main(argv=None) -> None:
    args = parse_args(argv)
    joins = args.mesh and not torch.distributed.is_initialized()
    mesh = make_mesh(args)
    try:
        trainer = make_trainer(args, mesh)
        _, history = trainer.train(rng.PRNGKey(args.seed), args.updates, log_every=10)
    finally:
        if joins and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if mesh is None or mesh.rank == 0:
        for h in history:
            print(json.dumps(h))


if __name__ == "__main__":
    main()
