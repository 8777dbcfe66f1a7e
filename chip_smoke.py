#!/usr/bin/env python3
"""The kernel table of PERF.md §6, measured on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels and prints the card's name and power limit.  Then,
for each of the port's eight kernels, a row at the reference default (the
four cast and render kernels on density-0.25 fuzz maps, 8x16, 4096 envs x
512 rays x 256 px) and a row at each path of ``paths()`` whose run launches
it, on the inputs that path hands the kernel's wrapper over a reset and
STEPS steps (threefry: the path's distinct hashes together; the fill, the
RGB conversion and Maze's reset: each distinct shape):

* kernel == plain, exact: the row's precondition;
* device ms per launch (torch.profiler's CUDA activity over at least
  PROFILED_LAUNCHES launches after a warm-up: the median, or the mean over
  a group of hashes), the wrapper's host ms per call (CUDA events around 20
  calls), the plain version's ms;
* the bound, ``benchmark/roofline.py``'s peaks over the bytes and
  operations the inputs need, and the share of bound (bound / device ms);
* launches per step, ``profiling.total("kernel_launches.<kernel>")`` over
  the path's steps.

The card's line again, the rows' JSON and ``{"ok": true, ...}`` come last.
The ``cuda`` tests hold the kernels and paths to their plain versions
(README); a machine without a CUDA device exits non-zero before a row.
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import json
import math
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
STEPS = 4
PROFILED_LAUNCHES = 60
TRACE_DIR = os.path.join(ROOT, "raycastworlds_tpu_torch", "_build", "traces")
# threefry: integer operations of the hash an element (20 rounds of add,
# rotate and xor, 5 key injections of 3 adds, 3 to set up), and the H100
# SXM's int32 issue rate, 64 lanes a clock per SM x 132 SMs x 1.98 GHz
THREEFRY_OPS = 78
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# kernel -> (module, wrapper): the wrapper launches the kernel once a call
WRAPPERS = {
    "crossing_cast": ("raycastworlds_tpu_torch.ops.raycast_crossing_kernel",
                      "cast_rays_crossing_kernel"),
    "crossing_render_pal8": ("raycastworlds_tpu_torch.ops.raycast_crossing_kernel",
                             "cast_render_pal8_kernel"),
    "dda_cast": ("raycastworlds_tpu_torch.ops.raycast_pallas", "cast_rays_pallas_batched"),
    "dda_render_u32": ("raycastworlds_tpu_torch.ops.render_fused",
                       "render_camera_fused_batched"),
    "threefry": ("raycastworlds_tpu_torch.rng", "_hash_kernel"),
    "flood_fill": ("raycastworlds_tpu_torch.ops.flood", "_flood_fill_kernel"),
    "u32_to_rgb": ("raycastworlds_tpu_torch.ops.render", "_u32_to_rgb_kernel"),
    "maze_reset": ("raycastworlds_tpu_torch.models.maze", "_maze_reset_kernel"),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def wrapper(name):
    module, attr = WRAPPERS[name]
    return getattr(importlib.import_module(module), attr)


def plain_hash(key, g, pair):
    """The plain threefry of ``key`` over geometry ``g`` (``rng._Geometry``):
    ``rng.threefry2x32`` over the counters the kernel computes."""
    import torch

    from raycastworlds_tpu_torch import rng

    j = torch.arange(math.prod(g.local), dtype=torch.int64, device=key.device)
    q = j // g.inner
    counts = ((q // g.local_len * g.global_len + g.start + q % g.local_len) * g.inner
              + j % g.inner).reshape(g.local)
    expand = (...,) + (None,) * len(g.local)
    b0, b1 = rng.threefry2x32(key[..., 0][expand], key[..., 1][expand],
                              torch.zeros_like(counts), counts)
    return torch.stack([b0, b1], dim=-1) if pair else b0 ^ b1


def plain(name):
    """The kernel's plain PyTorch version (the wrapper's arguments)."""
    from raycastworlds_tpu_torch.models.maze import Maze
    from raycastworlds_tpu_torch.ops import flood, raycast, render, render_fused
    from raycastworlds_tpu_torch.ops import raycast_crossing_kernel as rck

    return {
        "crossing_cast": rck.cast_rays_crossing_kernel_ref,
        "crossing_render_pal8": rck.cast_render_pal8_kernel_ref,
        "dda_cast": raycast.cast_rays_scan,
        "dda_render_u32": render_fused.render_camera_fused_batched_ref,
        "threefry": plain_hash,
        "flood_fill": flood.flood_fill_plain,
        "u32_to_rgb": render.u32_to_rgb_plain,
        "maze_reset": lambda cfg, keys: Maze(cfg).reset_batch_plain(keys),
    }[name]


@contextlib.contextmanager
def recorded():
    """Within ``with recorded() as seen:`` the first call of each kernel's
    wrapper with each signature (its tensors' shapes and dtypes, its other
    arguments) is kept, its tensors cloned: ``seen[kernel][signature] =
    args``, every argument positional."""
    import torch

    def sig(x):
        if torch.is_tensor(x):
            return tuple(x.shape), x.dtype
        try:
            hash(x)
            return x
        except TypeError:
            return repr(x)

    seen = {name: {} for name in WRAPPERS}
    real = {name: wrapper(name) for name in WRAPPERS}
    for name, fn in real.items():
        def record(*args, _name=name, _fn=fn, **kwargs):
            call = inspect.signature(_fn).bind(*args, **kwargs).args
            seen[_name].setdefault(tuple(sig(a) for a in call), tuple(
                a.clone() if torch.is_tensor(a) else a for a in call))
            return _fn(*args, **kwargs)

        setattr(importlib.import_module(WRAPPERS[name][0]), WRAPPERS[name][1], record)
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(importlib.import_module(WRAPPERS[name][0]), WRAPPERS[name][1], fn)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, after warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(name, fn, per_call: int) -> float:
    """Device time of one launch of kernel ``name`` (the CUDA function
    ``{name}_kernel``), from torch.profiler's CUDA activity over calls of
    ``fn`` (``per_call`` launches each, of different inputs where more than
    one: their mean, else the median) after a warm-up.  The
    profiler can drop kernel records from a window; windows are repeated (at
    most 5) until PROFILED_LAUNCHES durations are in.  The last trace is
    kept under TRACE_DIR."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, f"{name}.json")
    durs = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(-(-PROFILED_LAUNCHES // per_call)):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        durs += [e["dur"] for e in events
                 if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel"
                 and f"{name}_kernel" in e.get("name", "")]
        if len(durs) >= PROFILED_LAUNCHES:
            return float((np.median if per_call == 1 else np.mean)(durs)) / 1e3
    raise RuntimeError(f"chip_smoke check failed: the profiler saw {len(durs)} launches "
                       f"of {name}_kernel in 5 windows")


def work(name, args, out):
    """(bytes, operations, bound seconds) of one call of kernel ``name`` on
    ``args`` with output ``out``.  Casts and renders as
    ``benchmark/roofline.py`` counts them (maps and poses read once, hits or
    frames written once, 4 operations a grid line crossed up to the hit,
    counted by the plain scan, 2 compares a rendered pixel); threefry, its
    keys read and outputs written once and THREEFRY_OPS an element; the
    fill, its bool map read, int32 seeds read and bool result written; the
    RGB conversion, 4 bytes read and 3 written a pixel, as the benchmark's
    ``rgb_convert_roofline`` counts them; Maze's reset, its keys read and
    its state written once and THREEFRY_OPS a hash of ``maze_hashes``."""
    import torch

    from benchmark import roofline
    from raycastworlds_tpu_torch.ops import raycast

    if name == "threefry":
        key, g, pair = args
        keys, elems = key[..., 0].numel(), math.prod(g.local)
        nbytes, ops = keys * (16 + elems * (16 if pair else 8)), keys * elems * THREEFRY_OPS
        return nbytes, ops, max(nbytes / roofline.HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
    if name == "flood_fill":
        passable, seed_tu, _ = args
        nbytes = 2 * passable.numel() + 4 * seed_tu.numel()
        return nbytes, 0, roofline.bound_s(nbytes, 0)
    if name == "u32_to_rgb":
        nbytes = 7 * args[0].numel()
        return nbytes, 0, roofline.bound_s(nbytes, 0)
    if name == "maze_reset":
        cfg, keys = args
        nbytes = keys.numel() * keys.element_size() + sum(
            x.numel() * x.element_size() for x in out.leaves().values())
        ops = keys.shape[0] * maze_hashes(cfg) * THREEFRY_OPS
        return nbytes, ops, max(nbytes / roofline.HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
    words, shape, pos, dirs = (args[0], args[2], args[3], args[5]) if name == "dda_render_u32" \
        else args[:4]
    b, r = dirs.shape[:2]
    hit_tu = raycast.cast_rays_scan(words, shape, pos, dirs, sum(shape))[0]
    crossings = int((hit_tu.to(torch.int64)
                     - torch.floor(pos).to(torch.int64)[:, None, :]).abs().sum())
    nbytes, ops = roofline.cast_work(b, r, *shape, crossings)
    if not name.endswith("cast"):  # a cast and render: the frame in place of the hits
        nbytes += out.numel() * out.element_size() - b * r * roofline.HIT_BYTES
        ops += 2 * out.numel()
    return nbytes, ops, roofline.bound_s(nbytes, ops)


def maze_hashes(cfg) -> int:
    """Threefry hashes of one Maze reset: split(key, 5), the map key's
    split, a coin a cell, the rooms' split and 14 a room (its split and two
    randints of shape (2,): a split and 2 + 2 words each), the goal's and
    the spawn's uniforms, and the heading (a uniform, or a randint's 4)."""
    cells = (cfg.H - 1) // 2 * ((cfg.W - 1) // 2)
    rooms = cfg.num_rooms + 14 * cfg.num_rooms
    return 5 + 2 + cells + rooms + 2 + (1 if cfg.continuous_heading else 4)


def shape_of(name, calls) -> str:
    args = calls[0]
    if name == "threefry":
        return f"{len(calls)} distinct hashes"
    if name == "flood_fill":
        return f"fill {list(args[0].shape)}"
    if name == "u32_to_rgb":
        return f"frames {list(args[0].shape)}"
    if name == "maze_reset":
        return f"reset [{args[1].shape[0]}, {args[0].H}, {args[0].W}]"
    shape, dirs = (args[2], args[5]) if name == "dda_render_u32" else (args[1], args[3])
    hpu = {"crossing_render_pal8": 6, "dda_render_u32": 7}.get(name)
    return (f"{shape[0]}x{shape[1]} B={dirs.shape[0]} R={dirs.shape[1]}"
            + ("" if hpu is None else f" hpu {args[hpu]}"))


def measure(name, label, calls, launches_per_step) -> dict:
    """The row of kernel ``name`` on ``calls`` (argument tuples): kernel ==
    plain, then its times, bound and share (module docstring)."""
    import torch

    fn, ref = wrapper(name), plain(name)
    kernel = lambda: [fn(*a) for a in calls]  # noqa: E731
    plain_fn = lambda: [ref(*a) for a in calls]  # noqa: E731
    got, want = kernel(), plain_fn()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if name == "maze_reset":  # an EnvState: every leaf
            g, w = tuple(g.leaves().values()), tuple(w.leaves().values())
        g, w = (g, w) if isinstance(g, tuple) else ((g,), (w,))
        check(all(torch.equal(x, y) for x, y in zip(g, w)), f"{name} != plain at {label}")
    dev = device_ms(name, kernel, len(calls))
    host = time_ms(kernel, 20) / len(calls)
    plain_ms = time_ms(plain_fn, 3) / len(calls)
    works = [work(name, a, g if torch.is_tensor(g) or name == "maze_reset" else None)
             for a, g in zip(calls, got)]
    nbytes, ops = sum(w[0] for w in works), sum(w[1] for w in works)
    bound = sum(w[2] for w in works) * 1e3 / len(calls)
    row = dict(kernel=name, shape=f"{label}: {shape_of(name, calls)}",
               launches_per_step=launches_per_step, device_ms=dev, ms=host, plain_ms=plain_ms,
               bytes=nbytes, ops=ops, bound_ms=bound, bound_share=bound / dev)
    per_step = ("" if launches_per_step is None
                else f"{launches_per_step:g} launches per step; ")
    print(f"{name} at {row['shape']}: kernel == plain; {per_step}device {dev:.4f} ms per "
          f"launch, wrapper {host:.4f} ms, plain {plain_ms:.4f} ms; bound {bound:.6f} ms "
          f"({nbytes} B, {ops} ops), share {row['bound_share']:.4f}")
    return row


def reference_rows(device) -> list:
    """The four cast and render kernels at the reference default (8x16,
    4096 envs x 512 rays x 256 px): random walls (density 0.25) inside a
    border, random interior positions; random unit rays for the casts;
    for the renders blocks on 15% of the other tiles, a goal tile, random
    headings with their player directions and mirror-ordered fans.  The
    table's inputs since its first row, drawn the same way, so that the row
    compares across versions of the kernels."""
    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.ops import render
    from raycastworlds_tpu_torch.ops.bitmap import pack_bits_np

    h, w, b, r, hpu = 8, 16, 4096, 512, 256
    cfg = rt.EnvConfig(num_rays=r, height_camera_view_pu=hpu)
    rng = np.random.default_rng(SEED)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    packed = lambda m: t(pack_bits_np(m).view(np.int32))  # noqa: E731

    def walls():
        m = rng.random((b, h, w)) < 0.25
        m[:, 0, :] = m[:, -1, :] = True
        m[:, :, 0] = m[:, :, -1] = True
        return m

    cast_walls = walls()
    pos = rng.uniform([1.0, 1.0], [h - 1.0, w - 1.0], size=(b, 2)).astype(np.float32)
    ang = rng.uniform(0.0, 2.0 * np.pi, size=(b, r))
    dirs = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    cast = (packed(cast_walls), (h, w), t(pos), t(dirs))

    rng = np.random.default_rng(SEED)
    wall = walls()
    goal = rng.integers(1, [h - 1, w - 1], size=(b, 2)).astype(np.int32)
    wall[np.arange(b), goal[:, 0], goal[:, 1]] = False
    blocks = (rng.random((b, h, w)) < 0.15) & ~wall
    blocks[np.arange(b), goal[:, 0], goal[:, 1]] = False
    obst = wall | blocks
    obst[np.arange(b), goal[:, 0], goal[:, 1]] = True
    pos = rng.uniform([1.0, 1.0], [h - 1.0, w - 1.0], size=(b, 2)).astype(np.float32)
    dir_au = rng.integers(0, cfg.num_directions, size=b)
    pdir, fans = t(cfg.directions_wu[dir_au]), t(cfg.ray_fan_lut_flipped[dir_au])
    num, denom = render.render_constants(cfg)
    args = {
        "crossing_cast": cast,
        "dda_cast": cast + (h + w,),
        "crossing_render_pal8": (packed(obst), (h, w), t(pos), fans, pdir, t(goal), hpu, num,
                                 denom),
        "dda_render_u32": (packed(obst), packed(wall), (h, w), t(pos), pdir, fans, h + w, hpu,
                           num, denom),
    }
    return [measure(name, "reference default, fuzz maps", [a], None)
            for name, a in args.items()]


# -- the paths ---------------------------------------------------------------
# A path's drive(device, mark) makes a reset, calls mark(), then takes its
# steps and returns how many env steps they were (0: no steps).

def env_path(family, config, kw, envs, backend, budget=0):
    """Reset + STEPS steps of ``Env(family(config(**kw)))`` under
    ``backend``, uniform actions drawn on the host."""
    def drive(device, mark):
        import torch

        import raycastworlds_tpu_torch as rt

        game = getattr(rt, family)(getattr(rt, config)(**kw, raycast_backend=backend))
        env = rt.Env(game, num_envs=envs, device=device, reset_budget=budget)
        actions = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, game.num_actions, size=(STEPS, envs) + game.action_shape).astype(np.int32))
        state, _ = env.reset(rt.rng.PRNGKey(SEED, device))
        mark()
        for a in actions.to(device):
            state = env.step(state, a).state
        return STEPS
    return drive


def ppo_path(obs, envs, epochs, recurrent):
    """``init`` and one train step of a JAX bench PPO row: SingleRoom 64 x
    64 under ``auto``, the mlp trunk of hidden 256 in bfloat16, rollout 64,
    4 minibatches."""
    def drive(device, mark):
        import torch

        import raycastworlds_tpu_torch as rt
        from raycastworlds_tpu_torch.parallel.ppo import PPOConfig, PPOTrainer
        from raycastworlds_tpu_torch.parallel.ppo_rnn import RecurrentPPOTrainer

        cfg = rt.EnvConfig(num_rays=64, height_camera_view_pu=64, obs_type=obs)
        env = rt.Env(rt.SingleRoom(cfg), num_envs=envs, device=device)
        cls = RecurrentPPOTrainer if recurrent else PPOTrainer
        trainer = cls(env, PPOConfig(rollout_steps=64, num_epochs=epochs), hidden=256,
                      dtype=torch.bfloat16, trunk="mlp")
        ts = trainer.init(rt.rng.PRNGKey(SEED))
        mark()
        float(trainer.train_step(ts)[1]["loss"])
        return trainer.cfg.rollout_steps
    return drive


def vector_adapter(device, mark):
    """``GymVectorAdapter`` at flagship_single_room_4096 (64 x 64 u32)."""
    import raycastworlds_tpu_torch as rt

    adapter = rt.GymVectorAdapter(rt.SingleRoom(rt.EnvConfig(
        num_rays=64, height_camera_view_pu=64)), 4096, device=device)
    actions = np.random.default_rng(SEED).integers(0, 4, size=(STEPS, 4096)).astype(np.int32)
    adapter.reset(seed=SEED)
    mark()
    for a in actions:
        adapter.step(a)
    return STEPS


def gym_adapter(device, mark):
    """``GymAdapter`` at the reference default, a render after each step."""
    import raycastworlds_tpu_torch as rt

    adapter = rt.GymAdapter(rt.SingleRoom(rt.EnvConfig()), max_episode_steps=50, device=device)
    adapter.reset(seed=SEED)
    mark()
    for t in range(STEPS):
        step = adapter.step(t % 4)
        adapter.render()
        if step[2] or step[3]:
            adapter.reset(seed=t + 1)
    return STEPS


def single_path(backend, obs="camera_u32"):
    """One env of the reference default through the single-env API."""
    def drive(device, mark):
        import raycastworlds_tpu_torch as rt

        game = rt.SingleRoom(rt.EnvConfig(obs_type=obs, raycast_backend=backend))
        state = game.reset_single(rt.rng.PRNGKey(SEED, device), device)
        game.observe_single(state)
        mark()
        for t in range(STEPS):
            state = game.step_single(state, t % 4)
            if bool(state.done):
                state = game.reset_single(state.rng_key, device)
            game.observe_single(state)
        return STEPS
    return drive


def mesh_shard(device, mark):
    """Rank 1's sharded draws of a dp = 2 mesh of 4096 envs, rows [2048,
    4096): ``Env.reset``'s split, the throughput program's actions (axis
    1) and the policy's categorical."""
    import torch

    from raycastworlds_tpu_torch import rng

    start, stop = 2048, 4096
    rng.split(rng.PRNGKey(SEED, device), 4096, (start, stop))
    rng.randint(rng.PRNGKey(SEED + 1, device), (16, 4096), 0, 4, (start, stop), axis=1)
    rng.categorical(rng.PRNGKey(SEED + 2, device), torch.zeros(stop - start, 4, device=device),
                    (start, stop))
    return 0


def paths() -> list:
    """(label, drive) of every path: the main paths of each family (the
    reference default, the JAX bench rows' widths), the PPO rows, the
    adapters, one env through each kernel and a mesh rank's draws."""
    room = dict(height_tile_map_tu=16, width_tile_map_tu=16, num_rays=256,
                height_camera_view_pu=128)
    small = dict(num_rays=64, height_camera_view_pu=64)
    pal8 = dict(obs_type="camera_pal8")
    return [
        ("SingleRoom u32 auto", env_path("SingleRoom", "EnvConfig", {}, 4096, "auto")),
        ("SingleRoom u32 fused", env_path("SingleRoom", "EnvConfig", {}, 4096, "fused")),
        ("SingleRoom u32 pallas", env_path("SingleRoom", "EnvConfig", {}, 4096, "pallas")),
        ("SingleRoom pal8 crossing_kernel_fused",
         env_path("SingleRoom", "EnvConfig", pal8, 4096, "crossing_kernel_fused")),
        ("SingleRoom pal8 auto", env_path("SingleRoom", "EnvConfig", pal8, 1024, "auto")),
        ("RandomRoom rgb auto", env_path("RandomRoom", "RandomRoomConfig",
                                         dict(room, obs_type="camera_rgb"), 8192, "auto", 256)),
        ("SingleRoom top_rgb auto", env_path("SingleRoom", "EnvConfig",
                                             dict(pu_per_tu=8, obs_type="top_rgb"), 4096,
                                             "auto")),
        ("RandomRoom pal8 crossing_kernel_fused",
         env_path("RandomRoom", "RandomRoomConfig", dict(room, **pal8), 8192,
                  "crossing_kernel_fused", 256)),
        ("Maze u32 auto", env_path("Maze", "MazeConfig", small, 32768, "auto", 512)),
        ("DynamicRoom fused", env_path("DynamicRoom", "DynamicRoomConfig", small, 8192,
                                       "fused")),
        ("LockedRoom fused", env_path("LockedRoom", "LockedRoomConfig", small, 8192, "fused")),
        ("MultiGoalRoom pallas", env_path("MultiGoalRoom", "MultiGoalConfig", small, 8192,
                                          "pallas")),
        ("MultiPlayerRoom u32 auto", env_path("MultiPlayerRoom", "MultiPlayerConfig", small,
                                              4096, "auto")),
        ("MultiPlayerRoom block pallas",
         env_path("MultiPlayerRoom", "MultiPlayerConfig", dict(small, player_render="block"),
                  4096, "pallas")),
        ("MultiPlayerRoom pal8 crossing_kernel_fused",
         env_path("MultiPlayerRoom", "MultiPlayerConfig", dict(small, **pal8), 4096,
                  "crossing_kernel_fused")),
        ("checker u32 auto", env_path("SingleRoom", "EnvConfig", dict(wall_texture="checker"),
                                      4096, "auto")),
        ("brick u32 pallas", env_path("SingleRoom", "EnvConfig", dict(wall_texture="brick"),
                                      4096, "pallas")),
        ("xor pal8 crossing_kernel_fused",
         env_path("SingleRoom", "EnvConfig",
                  dict(wall_texture="xor", texture_cells=8, **pal8), 4096,
                  "crossing_kernel_fused")),
        ("PPO ppo_train_step_mlp_bf16", ppo_path("camera_gray", 2048, 2, False)),
        ("PPO ppo_train_step_throughput", ppo_path("camera_gray_u8", 4096, 1, False)),
        ("PPO ppo_train_step_recurrent_gru", ppo_path("camera_gray", 2048, 2, True)),
        ("GymVectorAdapter flagship u32", vector_adapter),
        ("GymAdapter reference default", gym_adapter),
        ("one env auto", single_path("auto")),
        ("one env pal8 crossing_kernel_fused",
         single_path("crossing_kernel_fused", "camera_pal8")),
        ("one env pallas", single_path("pallas")),
        ("one env fused", single_path("fused")),
        ("mesh dp=2 rank 1's sharded draws", mesh_shard),
    ]


def path_rows(label, drive, device) -> list:
    """The rows of every kernel ``drive`` launches, on what it handed each."""
    import torch

    from raycastworlds_tpu_torch.utils import profiling

    totals = lambda: {n: profiling.total(f"kernel_launches.{n}") for n in WRAPPERS}  # noqa: E731
    marked = {}
    with recorded() as seen:
        steps = drive(device, lambda: marked.update(totals()))
        torch.cuda.synchronize()
    after = totals()
    rows = []
    for name, calls in seen.items():
        per_step = (after[name] - marked[name]) / steps if steps else None
        groups = [list(calls.values())] if name == "threefry" else [[c] for c in calls.values()]
        rows += [measure(name, label, g, per_step) for g in groups if g]
    return rows


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    check(not sys.argv[1:], f"chip_smoke.py takes no arguments, not {sys.argv[1:]}")
    sys.path.insert(0, ROOT)
    from raycastworlds_tpu_torch import cuda_build

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    cuda_build.load()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {cuda_build.library_path()}")
    rows = reference_rows(device)
    for label, drive in paths():
        rows += path_rows(label, drive, device)
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"rows": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
