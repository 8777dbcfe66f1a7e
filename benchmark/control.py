"""The control of the check: the plain reference put in the program's place
and computed in the precision below the configuration's (bfloat16 for its
float32 geometry).  A check that passes the control is no check; every
compared number's upper reading comes from these runs (PERF.md).

    python3 benchmark/control.py --workload single_room_64.device_loop_4096 \
        --seconds 3 --seeds 11 12 13

runs the cell with the control as the system under test once per seed in
one process, on the CUDA device, and prints one JSON line per seed with
each compared number and its limit.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.reference import threefry  # noqa: E402

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class RefEnv:
    """The reference world behind ``Env``'s reset/step interface."""

    def __init__(self, world):
        self.world = world
        self.device = world.device

    def _state(self):
        w = self.world
        return SimpleNamespace(goal_tu=w.goal, pos_wu=w.pos, dir_au=w.dir,
                               rng_key=torch.from_numpy(w.keys.astype(np.int64)), t=w.t,
                               episode_return=w.ret, reward=w.reward, done=w.done)

    def reset(self, key: torch.Tensor):
        words = key.cpu().numpy().astype(np.uint32)
        self.world.reset(threefry.split(words, self.world.B))
        return self._state(), self.world.frames().view(torch.uint32)

    def step(self, state, action):
        reward, ended, truncated = self.world.step(action)
        info = {"terminated": ended & ~truncated, "truncated": truncated,
                "terminal_t": self.world.stepped_t, "episode_return": self.world.stepped_ret}
        return SimpleNamespace(state=self._state(), obs=self.world.frames().view(torch.uint32),
                               reward=reward, done=ended, info=info)


class RefAdapter:
    """The reference world behind ``GymVectorAdapter``'s interface."""

    def __init__(self, world):
        self.env = RefEnv(world)

    def reset(self, seed):
        key = threefry.split(threefry.key_of_seed(seed), 2)[1]
        _, obs = self.env.reset(torch.from_numpy(key.astype(np.int64)))
        return obs.view(torch.int32).cpu().numpy().view(np.uint32), {}

    def step(self, actions):
        res = self.env.step(None, torch.from_numpy(np.asarray(actions, dtype=np.int32)))
        host = lambda x: x.float().cpu().numpy() if x.is_floating_point() else x.cpu().numpy()  # noqa: E731
        info = {k: host(v) for k, v in res.info.items()}
        return (res.obs.view(torch.int32).cpu().numpy().view(np.uint32), host(res.reward),
                info["terminated"], info["truncated"], info)


class Control:
    """A program for the drivers: the reference world in ``dtype``."""

    def __init__(self, config, dtype=torch.bfloat16):
        self.reference = importlib.import_module(f"benchmark.reference.{config['reference']}")
        self.config = config
        self.dtype = dtype
        self.num_actions = self.reference.Spec(config["env"]).num_actions

    def _world(self, num_envs, device):
        return self.reference.World(self.config["env"], num_envs, device, self.dtype)

    def env(self, num_envs, device):
        return RefEnv(self._world(num_envs, device))

    def adapter(self, num_envs, device):
        return RefAdapter(self._world(num_envs, device))


def run(workload, seed, seconds, *, device=None, dtype=torch.bfloat16, overrides=None):
    """The harness's run of ``workload`` with the control in the program's
    place; returns the result line."""
    from benchmark import harness

    cell = harness.cell_of(harness.load_bench(), workload)
    config = harness.load_config(cell["config"])
    return harness.run(workload, seed, seconds, False, t0=time.perf_counter(),
                       device=device, program=Control(config, dtype), overrides=overrides)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16",
                   help="float32 puts the reference itself in the program's place")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no result: the control runs on a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = run(args.workload, seed, args.seconds, device="cuda", dtype=DTYPES[args.dtype])
        print(json.dumps({"workload": args.workload, "seed": seed, "dtype": args.dtype,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
