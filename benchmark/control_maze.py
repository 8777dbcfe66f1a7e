"""The control of the check for the maze cells: ``control_rgb.py``'s (the
plain reference put in the program's place, computed in the precision
below the configuration's, behind the budgeted ``Env``), over the
reference's maze world and its 0x00RRGGBB frames.

    python3 benchmark/control_maze.py --workload maze_17x17.device_loop_32768 \
        --seconds 3 --seeds 11 12 13

runs the cell with the control as the system under test once per seed in
one process, on the CUDA device, and prints one JSON line per seed with
each compared number and its limit.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import control, control_rgb  # noqa: E402
from benchmark.reference import maze  # noqa: E402


class Control(control_rgb.Control):
    """A program for the budgeted drivers: the reference maze in ``dtype``."""

    def _env(self, game, num_envs, device, reset_budget):
        return control_rgb.RefEnv(maze.World(self.env_config, num_envs, device, reset_budget,
                                             self.dtype))


def run(workload, seed, seconds, *, device=None, dtype=torch.bfloat16, overrides=None):
    """The harness's run of ``workload`` with the control in the program's
    place (built with ``overrides``' ``env`` keys too); returns the result
    line."""
    from benchmark import harness

    cell = harness.cell_of(harness.load_bench(), workload)
    config = harness.load_config(cell["config"])
    config = dict(config, env=dict(config["env"], **(overrides or {}).get("env", {})))
    return harness.run(workload, seed, seconds, False, t0=time.perf_counter(),
                       device=device, program=Control(config, dtype), overrides=overrides)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--dtype", choices=sorted(control.DTYPES), default="bfloat16",
                   help="float32 puts the reference itself in the program's place")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no result: the control runs on a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = run(args.workload, seed, args.seconds, device="cuda",
                dtype=control.DTYPES[args.dtype])
        print(json.dumps({"workload": args.workload, "seed": seed, "dtype": args.dtype,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
