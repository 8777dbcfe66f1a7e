"""The control of the check for the budgeted RGB cells: ``control.py``'s
(the plain reference put in the program's place, computed in the precision
below the configuration's), behind the ``rt.Env`` that the budgeted driver
(``drivers/device_loop_budget.py``) builds, with the reference's uint8 RGB
frames and its budgeted reset's leaves (``wall_map``, ``pending_reset``).

    python3 benchmark/control_rgb.py --workload random_room_rgb.device_loop_8192 \
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
from types import SimpleNamespace

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import control  # noqa: E402
from benchmark.reference import random_room, threefry  # noqa: E402


class RefEnv(control.RefEnv):
    """The reference world behind a budgeted ``Env``'s reset/step."""

    def _state(self):
        state = super()._state()
        state.wall_map, state.pending_reset = self.world.walls, self.world.pending
        return state

    def reset(self, key: torch.Tensor):
        words = key.cpu().numpy().astype(np.uint32)
        self.world.reset(threefry.split(words, self.world.B))
        return self._state(), self.world.frames()

    def step(self, state, action):
        reward, ended, truncated = self.world.step(action)
        info = {"terminated": ended & ~truncated, "truncated": truncated}
        return SimpleNamespace(state=self._state(), obs=self.world.frames(), reward=reward,
                               done=ended, info=info)


class Control:
    """A program for the budgeted driver: the reference world in ``dtype``."""

    def __init__(self, config, dtype=torch.bfloat16):
        self.env_config = config["env"]
        self.dtype = dtype
        self.game = None
        self.num_actions = random_room.Spec(config["env"]).num_actions
        self.rt = SimpleNamespace(Env=self._env)

    def _env(self, game, num_envs, device, reset_budget):
        return RefEnv(random_room.World(self.env_config, num_envs, device, reset_budget,
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
