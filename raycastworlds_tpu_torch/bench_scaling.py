"""Weak scaling of the env step over ranks: a fixed env count per rank, one
rank alone against all of them.

    python -m raycastworlds_tpu_torch.bench_scaling
    torchrun --nproc-per-node N -m raycastworlds_tpu_torch.bench_scaling

The port of the JAX package's ``bench_scaling.py`` (BASELINE's target: at
least 80% weak-scaling efficiency).  Rank 0 first measures one rank alone
(no mesh) at ``--envs-per-device`` envs, the others waiting; then every
rank measures the same program over the dp mesh of all ranks at N times
that many envs, with the reset budget scaled by N.  Each measurement is
``steps_per_second_program`` (random actions, every observation reduced to
a checksum on the device), warmed up once, best of 3, the timed region
ending on the host read of the checksum (all-reduced over dp).  Rank 0
prints one JSON line with the JAX script's keys.

By default rank r runs on ``cuda:LOCAL_RANK`` under NCCL; ``--device``
puts every rank on that device under gloo (``cpu``, or one card that the
ranks share, which measures nothing about scaling).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import Env, rng
from .bench import build_env
from .parallel import mesh as mesh_lib
from .parallel.rollout import steps_per_second_program


def measure(env: Env, steps: int, reps: int = 3) -> float:
    """Env-steps/s (global envs) of ``steps_per_second_program``: reset,
    one warm-up run, then the best of ``reps`` timed runs, rep ``r`` keyed
    by ``fold_in(key, r)``."""
    run = steps_per_second_program(env, steps)
    state, _ = env.reset(rng.PRNGKey(0))
    key = rng.PRNGKey(1)
    state, acc = run(state, key)
    float(acc)
    best = float("inf")
    for r in range(reps):
        t0 = time.perf_counter()
        state, acc = run(state, rng.fold_in(key, r))
        float(acc)
        best = min(best, time.perf_counter() - t0)
    return env.num_envs * steps / best


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--envs-per-device", type=int, default=4096)
    p.add_argument("--num-rays", type=int, default=64)
    p.add_argument("--height-px", type=int, default=64)
    p.add_argument("--steps", type=int, default=256)
    p.add_argument("--game", type=str, default="single_room")
    p.add_argument("--obs", type=str, default="camera_u32")
    p.add_argument("--reset-budget", type=int, default=0,
                   help="budgeted auto-reset per rank (scaled by N for the N-rank env)")
    p.add_argument("--map-h", type=int, default=0)
    p.add_argument("--map-w", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="every rank's device, under gloo (default: cuda:LOCAL_RANK, NCCL)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    joins = not torch.distributed.is_initialized()
    mesh_lib.initialize_distributed(backend="nccl" if args.device is None else "gloo")
    try:
        world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
        mesh = mesh_lib.make_mesh(devices=None if args.device is None else [args.device] * world)

        def make(num_envs, budget, m=None):
            return build_env(game=args.game, num_envs=num_envs, num_rays=args.num_rays,
                             height_px=args.height_px, obs=args.obs, map_h=args.map_h,
                             map_w=args.map_w, reset_budget=budget, device=mesh.device,
                             mesh=m)

        sps1 = None
        if mesh.rank == 0:
            sps1 = measure(make(args.envs_per_device, args.reset_budget), args.steps)
        mesh.barrier()
        result = {
            "metric": "scaling_efficiency",
            "devices": world,
            "config": {
                "game": args.game,
                "obs": args.obs,
                "envs_per_device": args.envs_per_device,
                "num_rays": args.num_rays,
                "height_px": args.height_px,
                "backend": mesh.device.type,
            },
            "steps_per_sec_1dev": None if sps1 is None else round(sps1, 1),
        }
        if world > 1:
            envs = make(args.envs_per_device * world, args.reset_budget * world, mesh)
            sps_n = measure(envs, args.steps)
            if mesh.rank == 0:
                eff = sps_n / (sps1 * world)
                result.update({
                    "steps_per_sec_Ndev": round(sps_n, 1),
                    "value": round(eff, 4),
                    "unit": "weak-scaling efficiency (1.0 = linear)",
                    "vs_baseline": round(eff / 0.8, 4),
                })
        else:
            result.update({"value": 1.0, "unit": "single device (no scaling measured)",
                           "vs_baseline": 1.0})
    finally:
        if joins and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if mesh.rank == 0:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
