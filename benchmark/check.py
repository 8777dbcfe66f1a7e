"""The comparison that decides ``correct``.

The plain reference (``reference/``) follows the whole run from the inputs
the benchmark made (the env-reset key and the action pool), env by env and
step by step, and every number below counts what the program produced
otherwise.  Each must be 0: the reference implements the same float32
semantics, every operation rounded alone, so a sound run equals it bit for
bit (the readings are in PERF.md).

* ``start_rows_off``: envs whose state after the first reset differs
  (goal, position, heading, key; the device loops);
* ``end_rows_off``: envs whose state after the last step differs (every
  leaf on the device loops; the step count and return the last ``info``
  reports on the host loop);
* ``reward_sums_off``: envs whose rewards summed over the run differ;
* ``ends_off``: envs whose count of episode ends or of truncations differs;
* ``col_sums_off``: (env, column) pairs whose column sums over every frame
  of the run differ (modulo 2**32 a frame on the host loop);
* ``last_px_off``: pixels of the last frames that differ.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference import threefry

BLOCK_ENVS = 256
NAMES = ("start_rows_off", "end_rows_off", "reward_sums_off", "ends_off",
         "col_sums_off", "last_px_off")


def rows_off(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> int:
    """Envs on which any leaf named in ``prog`` differs from ``ref``."""
    bad = None
    for name, value in prog.items():
        a = np.asarray(value).astype(np.float64)
        b = np.asarray(ref[name]).astype(np.float64)
        if a.shape != b.shape:
            return int(b.shape[0])
        diff = (a != b).reshape(a.shape[0], -1).any(axis=1)
        bad = diff if bad is None else bad | diff
    return int(bad.sum())


def compare(config: Dict, out: Dict, device) -> List[Tuple[str, int, int]]:
    """(name, value, limit) of each number compared."""
    b = out["num_envs"]
    reference = importlib.import_module(f"benchmark.reference.{config['reference']}")
    world = reference.World(config["env"], b, device)
    world.reset(threefry.split(out["key"], b))
    checks = {}
    if out["start"] is not None:
        checks["start_rows_off"] = rows_off(
            {k: out["start"][k] for k in ("goal_tu", "pos_wu", "dir_au", "rng_key")},
            world.leaves())
    mod = out["col_mod"]

    def col_sums():
        c = world.column_sums()
        return c % mod if mod else c

    cols = col_sums()
    rewards = torch.zeros(b, dtype=torch.float64, device=world.device)
    ends = torch.zeros(b, dtype=torch.int64, device=world.device)
    truncs = torch.zeros(b, dtype=torch.int64, device=world.device)
    pool = out["pool"].to(world.device)
    for t in range(out["steps"]):
        reward, ended, truncated = world.step(pool[t % pool.shape[0]])
        cols += col_sums()
        rewards += reward
        ends += ended
        truncs += truncated
    ref_leaves = world.leaves()
    # the last info's count and return are the finishing move's, pre-reset
    ref_leaves["terminal_t"] = world.stepped_t.cpu().numpy()
    ref_leaves["terminal_return"] = world.stepped_ret.float().cpu().numpy()
    checks["end_rows_off"] = rows_off(out["end"], ref_leaves)
    checks["reward_sums_off"] = int((np.asarray(out["rewards"]) != rewards.cpu().numpy()).sum())
    checks["ends_off"] = int(((np.asarray(out["ends"]) != ends.cpu().numpy())
                              | (np.asarray(out["truncs"]) != truncs.cpu().numpy())).sum())
    checks["col_sums_off"] = int((np.asarray(out["cols"]) != cols.cpu().numpy()).sum())
    last = out["last_obs"]
    px = 0
    for lo in range(0, b, BLOCK_ENVS):
        rows = torch.arange(lo, min(b, lo + BLOCK_ENVS), device=world.device)
        ref = world.frames(rows)
        got = last[lo:lo + BLOCK_ENVS].to(world.device)
        px += int((got != ref).sum()) if got.shape == ref.shape else ref.numel()
    checks["last_px_off"] = px
    return [(name, checks[name], 0) for name in NAMES if name in checks]
