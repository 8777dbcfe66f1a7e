"""Named per-kernel device-time breakdown of an env step.

    python -m raycastworlds_tpu_torch.examples.profile_step            # flagship row
    python -m raycastworlds_tpu_torch.examples.profile_step --num-envs 4096 --steps 16
    python -m raycastworlds_tpu_torch.examples.profile_step --device cpu --num-envs 4

The port of the JAX package's ``examples/profile_step.py``.  Runs the
throughput program (``steps_per_second_program``: random actions, dense or
budgeted auto-reset, every observation reduced to a checksum on the device)
of one bench row (``bench_scaling.build_env``; the flagship row by default:
SingleRoom, 4096 envs x 64 rays x 64 px, camera_u32, ``auto``) once to warm
up, once timed on the host clock alone, and once under
``utils/profiling.trace``, which turns the port's tracer on, so the
trace holds its spans.  Then it sums the trace's kernels by name
(``aggregate_trace``) and prints one JSON line: the wall ms per step, the
device ms per step and the busy share (device / wall), the device time
launched inside the auto-reset (``reset_batch``: the span
``rcw.env.reset``, the dense reset with its select) and inside the
threefry hash (``threefry``: the span ``rcw.rng.threefry``), and the top
``--top`` kernels with their ms, calls, ns per env-step and share of
device time.  On the CPU the "kernels" are torch.profiler's CPU operators,
which nest, so their shares overlap.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--num-rays", type=int, default=64)
    p.add_argument("--height-px", type=int, default=64)
    p.add_argument("--obs", type=str, default="camera_u32")
    p.add_argument("--game", type=str, default="single_room")
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--raycast", type=str, default="auto")
    p.add_argument("--reset-budget", type=int, default=0)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--trace-dir", type=str,
                   default=os.path.join(tempfile.gettempdir(), "rcw_trace_step"))
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    from raycastworlds_tpu_torch import rng
    from raycastworlds_tpu_torch.bench_scaling import build_env
    from raycastworlds_tpu_torch.parallel.rollout import steps_per_second_program
    from raycastworlds_tpu_torch.utils.profiling import aggregate_trace, trace

    env = build_env(args.game, args.num_envs, args.num_rays, args.height_px, args.obs,
                    reset_budget=args.reset_budget, device=args.device, raycast=args.raycast)
    cuda = env.device.type == "cuda"
    state, _ = env.reset(rng.PRNGKey(0))
    run = steps_per_second_program(env, args.steps)
    key = rng.PRNGKey(1)
    state, acc = run(state, key)
    float(acc)  # warm-up

    t0 = time.perf_counter()
    state, acc = run(state, key)
    float(acc)
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    shutil.rmtree(args.trace_dir, ignore_errors=True)
    with trace(args.trace_dir):
        t0 = time.perf_counter()
        state, acc = run(state, key)
        float(acc)
        profiled_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    spans = {"reset_batch": "rcw.env.reset", "threefry": "rcw.rng.threefry"}
    us, calls, within = aggregate_trace(args.trace_dir, "kernel" if cuda else "cpu_op",
                                        within=list(spans.values()))
    total = sum(us.values())
    denom = args.num_envs * args.steps
    device_ms = total / 1e3 / args.steps
    rows = [{
        "kernel": name,
        "ms": t / 1e3,
        "calls": calls[name],
        "ns_per_env_step": t * 1e3 / denom,
        "pct": 100.0 * t / total,
    } for name, t in us.most_common(args.top)]
    out = {
        "config": vars(args),
        "device": str(env.device),
        "events": "CUDA kernels" if cuda else "CPU operators (nested)",
        "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": profiled_ms,
        "device_ms_per_step": device_ms,
        "busy": device_ms / wall_ms,
        "kernels_per_step": sum(calls.values()) / args.steps,
        "ns_per_env_step_total": total * 1e3 / denom,
        "within": {label: {"ms_per_step": within[name] / 1e3 / args.steps,
                           "pct": 100.0 * within[name] / total if total else 0.0}
                   for label, name in spans.items()},
        "kernels": rows,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
