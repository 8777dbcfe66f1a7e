"""Rollout demo: random rollouts on the device with metrics.

    python -m raycastworlds_tpu_torch.examples.rollout_demo --num-envs 4096 --chunks 20
    python -m raycastworlds_tpu_torch.examples.rollout_demo --device cpu --num-envs 8

The port of the JAX package's ``examples/rollout_demo.py``: chunks of
``rollout_random`` reduced on the device by ``device_metrics``, a host-side
``Meter`` fed once per chunk (after one warm-up chunk), the chunk key
advanced by ``rng.fold_in``, an optional profiler trace, and the meter's
snapshot as one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--game", choices=["single_room", "random_room", "maze"],
                   default="single_room")
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--chunk-steps", type=int, default=128)
    p.add_argument("--chunks", type=int, default=10)
    p.add_argument("--num-rays", type=int, default=64)
    p.add_argument("--height-px", type=int, default=64)
    p.add_argument("--trace-dir", type=str, default="",
                   help="write a torch.profiler Chrome trace of the timed chunks here")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.parallel.rollout import rollout_random
    from raycastworlds_tpu_torch.utils.profiling import Meter, device_metrics, trace

    kw = dict(num_rays=args.num_rays, height_camera_view_pu=args.height_px)
    if args.game == "single_room":
        game = rt.SingleRoom(rt.EnvConfig(**kw))
    elif args.game == "random_room":
        game = rt.RandomRoom(rt.RandomRoomConfig(
            height_tile_map_tu=16, width_tile_map_tu=16, **kw))
    else:
        game = rt.Maze(rt.MazeConfig(**kw))
    env = rt.Env(game, num_envs=args.num_envs, device=args.device)

    def chunk(state, key):
        state, traj = rollout_random(env, state, key, args.chunk_steps)
        return state, device_metrics(traj.done, traj.reward)

    state, _ = env.reset(rt.rng.PRNGKey(0))
    key = rt.rng.PRNGKey(1)

    # warm-up outside the meter
    state, m = chunk(state, key)
    {k: float(v) for k, v in m.items()}

    meter = Meter()
    with trace(args.trace_dir) if args.trace_dir else contextlib.nullcontext():
        for c in range(args.chunks):
            key = rt.rng.fold_in(key, c)
            state, m = chunk(state, key)
            meter.update({k: float(v) for k, v in m.items()})
    snap = meter.snapshot()
    print(json.dumps(snap))
    return snap


if __name__ == "__main__":
    main()
