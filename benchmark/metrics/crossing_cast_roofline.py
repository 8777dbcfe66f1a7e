"""The crossing cast kernel's share of its roofline, in %: the least time
the H100 could take for the casts of the traced stretch (each env's packed
map and pose read once and each ray's hit written once, against four float
operations per grid line crossed up to the hit, counted by the plain
reference on the very poses each cast was given; ``roofline.cast_work``)
over the device time of the ``crossing_cast`` kernels.  Silent where no
such kernel ran."""

import importlib

import torch

from benchmark import roofline

SPANS = {"models.cast_batch": "game.cast_batch"}
KEEP = ("models.cast_batch",)


def read(trace, ctx):
    kernels = [o for o in trace.kernels if "crossing_cast" in o.name]
    calls = ctx.kept.get("models.cast_batch", [])
    busy_us = sum(o.dur for o in kernels)
    if not kernels or not calls or busy_us <= 0:
        return None
    env = ctx.config["env"]
    reference = importlib.import_module(f"benchmark.reference.{ctx.config['reference']}")
    bounds = []
    for args in calls:
        state = args[-1]
        crossings = reference.World.at(env, state.pos_wu, state.dir_au,
                                       state.goal_tu).crossings()
        nbytes, flops = roofline.cast_work(
            state.pos_wu.shape[0], env["num_rays"], env["height_tile_map_tu"],
            env["width_tile_map_tu"], int(torch.sum(crossings)))
        bounds.append(roofline.bound_s(nbytes, flops))
    per_call = sum(bounds) / len(bounds)
    return 100.0 * per_call * len(kernels) / (busy_us / 1e6)
