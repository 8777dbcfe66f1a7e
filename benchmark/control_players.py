"""The control of the check for the multi-player cells: ``control.py``'s
(the plain reference put in the program's place, computed in the precision
below the configuration's), behind the ``Env`` interface that the players'
driver (``drivers/device_loop_players.py``) steps: actions [B, P], rewards
[B, P], frames [B, P, H, R].

    python3 benchmark/control_players.py \
        --workload multi_player_2p.device_loop_players_4096 --seconds 3 --seeds 11 12 13

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

import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import control  # noqa: E402


class RefEnv(control.RefEnv):
    """The reference world behind ``Env``'s reset/step, with each player's
    reward."""

    def step(self, state, action):
        res = super().step(state, action)
        res.reward = self.world.reward
        return res


class Control(control.Control):
    """A program for the players' driver: the reference world in ``dtype``,
    and the game's action shape (one action per player)."""

    def __init__(self, config, dtype=torch.bfloat16):
        super().__init__(config, dtype)
        self.game = SimpleNamespace(
            action_shape=(self.reference.Spec(config["env"]).P,))

    def env(self, num_envs, device):
        return RefEnv(self._world(num_envs, device))


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
