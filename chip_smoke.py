#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase below
    python3 chip_smoke.py --times-only   # phases 1, 2 and the kernel times (threefry's too)
    python3 chip_smoke.py --mesh-only    # phases 1, 2 and 8
    python3 chip_smoke.py --adapters-only  # phases 1, 2 and 9
    python3 chip_smoke.py --single-only    # phases 1, 2 and 10
    python3 chip_smoke.py --bench-only     # phases 1, 2 and 11
    python3 chip_smoke.py --flood-only     # phases 1, 2 and the flood fill rows

Builds the CUDA kernels from ``raycastworlds_tpu_torch/csrc`` and drives the
port's main paths, ``Env(Family(Config(raycast_backend=B)))`` with dense or
budgeted auto-reset, on the card.  Phases, each printing a line:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. the kernel build and its seconds;
3. each kernel against its plain PyTorch version on the card, exact on
   every output: at the reference-default shape (4096 envs x 512 rays x 256
   px, 8x16 map), at maps 13x9, 24x40 and 48x48, on sliding inputs
   (integer positions and axis-parallel rays); the DDA kernels also with a
   truncated march, the fused u32 render with and without block words; the
   crossing, DDA and pal8 kernels also on maps without a border ring, on
   rays with a tiny component (t overflows partway along the axis) and on
   diagonal rays from tile corners, at the main paths' maps and ray counts;
   the crossing and DDA casts also at 1 and 80 rays per env and on a
   336x336 map at 2 rays (the crossing cast's block layouts); then each
   kernel's times and bound at the reference-default shape (as in phase 6);
   then the threefry kernel at each main path's own draws, recorded as
   the program makes them: a reset and THREEFRY_STEPS steps of each
   family's main path at its own batch (SingleRoom 4096 envs first), a
   train step of each PPO row (its categorical and permutation), and rank
   1's sharded draws of phase 8's dp = 2 mesh; every distinct hash equal
   to the plain path (``rng.threefry2x32``) on the card and on the CPU,
   one launch a hash, each path's launches per step read over its steps,
   and its hashes' times and bound (int32 operations over 64 x 132 x
   1.98e9 a second, or bytes); then the flood fill kernel at RandomRoom's
   own fills, recorded as the camera_rgb main path makes them (8192 envs,
   budget 256: the first reset's [8192, 16, 16] and the budgeted resets'
   [256, 16, 16]), one launch a reset, each fill equal to the plain path
   (``flood.flood_fill_plain``) on the card and on the CPU, with the
   dilations its envs need to reach their fixed point, and its times and
   bound (bytes: the bool map read, the seeds read, the bool result
   written);
4. the golden frames of tests/data/golden_frames.npz ("single_room", its
   checker, brick and xor textured twins, "multi_player" and "top_view",
   pinned from the JAX package) reproduced through the crossing kernel;
   then the top_u32 observation of SingleRoom (512 rays) and
   MultiPlayerRoom (the main path's config) at 256 envs on the card equal
   to the same states' on the CPU, with the card's ms per call; then the
   textured camera_pal8 frames of the reference default at 4096 envs
   decoding through the extended palette to the camera_u32 frames of the
   same states (checker, brick, xor);
5. the main paths, reset plus 64 steps of the throughput program, through
   the kernels (launch count = observations made, no other kernel
   launched) and through the plain paths, with identical final states and
   checksums, and the env-steps/s of each run:
   * SingleRoom (reference default, 8x16, 512 rays x 256 px) at 4096 envs:
     ``auto`` (the crossing kernel) against ``crossing``; ``fused`` and
     ``pallas`` against ``scan`` (camera_u32); ``crossing_kernel_fused``
     against ``crossing`` and ``crossing_kernel`` (camera_pal8); and
     ``auto`` in camera_pal8 at 1024 envs;
   * the other families at the widths of the JAX package's bench rows:
     RandomRoom 16x16, 256 rays x 128 px, 8192 envs, reset budget 256, in
     camera_rgb (``auto`` against ``crossing``) and camera_pal8
     (``crossing_kernel_fused`` against ``crossing`` and
     ``crossing_kernel``); Maze 17x17, 64 x 64, 32768 envs, budget 512
     (``auto`` against ``crossing``); DynamicRoom and LockedRoom, 64 x 64,
     8192 envs, ``fused`` (block and door words) against ``scan``;
     MultiGoalRoom, 64 x 64, 8192 envs, ``pallas`` against ``scan``, and
     ``analytic`` (no kernel) against ``crossing``: identical states,
     checksums within 1e-6 relative, reset frames 99.9% equal;
   * MultiPlayerRoom at the JAX bench row ``multi_player_2p_4096``: 2
     players, sprites, 8x16, 64 x 64, 4096 envs, so 8192 casts per
     observation in one launch: camera_u32 ``auto`` against ``crossing``,
     block players under ``pallas`` against ``scan``, and camera_pal8
     under ``crossing_kernel_fused`` (the crossing cast, never the pal8
     kernel) against ``crossing``;
   * textured SingleRoom at the reference default (4096 envs, 512 rays x
     256 px): checker camera_u32 ``auto`` (the crossing cast; its peak
     device memory printed) against ``crossing``, brick camera_u32
     ``pallas`` (the DDA cast) against ``scan``, and xor camera_pal8
     ``crossing_kernel_fused`` (the crossing cast, never the pal8 kernel:
     textures render after the cast) against ``crossing``.
   Each budgeted phase prints how many envs its budget reset.  Then the
   configs no kernel takes: SingleRoom at the reference default with
   continuous headings (turn 0.7 angle units) and in float64, 4096 envs
   under ``auto`` launching no kernel, and at 64 envs over 16 steps the
   card's states and frames equal to the CPU's; and a 640x640 map, whose
   12,800 packed words pass the kernels' shared-memory cap (the Python
   ``KERNEL_MAX_WORDS``, checked equal to the library's), resolving
   ``auto`` to the plain crossing cast and stepping on the card.  Then a
   profile of 5 steps of the MultiPlayerRoom camera_u32 path and of the
   checker camera_u32 path: wall and device ms per step, the device's busy
   share and kernels per step.
6. each main path's kernel at that path's shape, on the inputs its
   ``observe_batch`` hands the kernel after a ``reset_batch``: kernel ==
   plain, the device time per launch (torch.profiler's CUDA activity, the
   median of at least 60 launches after a warm-up; traces under
   ``raycastworlds_tpu_torch/_build/traces/``), the wrapper's host time
   per call (CUDA events around 20 calls), the plain version's time, the
   bound (the larger of the bytes read and written over 3.35 TB/s and the
   float operations this data needs over 67 TFLOP/s) and the share of
   bound (bound / device time); the crossing cast also at the PPO rows'
   shapes ([2048, 64] and [4096, 64]) and at phase 9's adapter shapes
   (the flagship [4096, 64] and the single env's [1, 512]);
7. the JAX bench's three PPO rows at full width (SingleRoom 64 rays x 64
   px under ``auto``, mlp trunk of hidden 256 in bfloat16, rollout 64, 4
   minibatches): ``ppo_train_step_mlp_bf16`` (camera_gray, 2048 envs, 2
   epochs), ``ppo_train_step_throughput`` (camera_gray_u8, 4096 envs, 1
   epoch) and ``ppo_train_step_recurrent_gru`` (the GRU trainer, as the
   first).  Each: ``init``, a warm-up ``train_step`` and 2 timed ones, with
   ``crossing_cast`` launched once per observation (the reset's, then 66
   per feedforward step, 65 per GRU step) and no other kernel, finite
   metrics and moved params; env-steps/s through the train step, the
   rollout and update phases' ms (CUDA-synchronised) and the peak device
   memory.  Then one float32 train step of the first row through the
   kernel and through the plain crossing cast from one key (TF32 off):
   identical actions, rewards, dones and final states, params within 1e-5;
   the host ms of each layer of the first row's train step alone (env
   step, policy forward, sampling, key split, GAE, permutation, one
   minibatch's forward and backward, one Adam update); and a torch.profiler
   profile of one feedforward train step (wall and device ms, busy share,
   device activities).
8. the mesh (``parallel/mesh.py``) at the PPO rows' widths in float32
   (SingleRoom 64 x 64 gray, mlp hidden 256, rollout 64, 4 minibatches, 2
   epochs; TF32 off): one rank under NCCL (dp = 1, 2048 envs), the
   feedforward and GRU trainers with a mesh equal to the same trainers
   without one (identical rollouts, params within 1e-5); two ranks sharing
   the card under gloo on CUDA tensors (dp = 2, 4096 global envs): reset +
   16 steps and the budgeted RandomRoom row (8192 envs, budget 256, every
   episode truncated at step 8 so that the budget walks across the shard
   boundary) equal to the one-process card run bit for bit, and one
   feedforward and one GRU train step whose rollouts are the one-process
   run's, with the params bit-identical on both ranks; four ranks (dp = 2
   x mp = 2) take one feedforward step with the rollout cut to 16 steps to
   fit the time: its rollout equals the dp = 2 run's from the same state,
   its first minibatch's loss and gathered gradients are within 1e-4 of
   dp = 2's, and its params after the step's 8 Adam updates are printed
   beside the dp = 2 step's response to a one-ulp nudge of
   ``trunk.weight``.  Every rank launches ``crossing_cast`` once per
   observation and no other kernel.  Prints ms per train step per
   topology and the collectives' host ms per update (none of it is a
   scaling figure: the ranks share one card); then ``bench_scaling``'s
   JSON line at one rank.
9. the adapters and tools, each run counted (``crossing_cast`` once per
   observation or view made, no other kernel): (a) ``GymVectorAdapter`` at
   flagship_single_room_4096 (SingleRoom 64 x 64 camera_u32 ``auto``, 4096
   envs, reset + 64 steps), every returned array equal to ``Env.reset`` /
   ``Env.step`` on the card with the same keys and its first 256 envs x 16
   steps to a CPU adapter, again with ``final_observation``; env-steps/s
   through the adapter beside ``steps_per_second_program``'s, host-copy ms
   per step, launches per step; (b) ``GymAdapter`` at the reference default
   (1 env, 100 steps with renders, re-seeded resets) equal to the CPU's, ms
   per step; (c) ``FrameStack(4)`` over gray_u8 and
   ``ObsTransform(downsample2x)`` over u32, 4096 envs x 32 steps, the first
   256 envs equal to the CPU's; (d) ``record_episode`` camera and top views
   of the reference default and MultiPlayerRoom, frames and GIF bytes
   equal to the CPU's; (e) ``WebPlaySession`` PNG frames and statuses
   through a key script equal to the CPU's, ms per key; (f)
   ``validate_state`` and ``checked`` on (a)'s final state, a NaN state
   throwing; (g) ``examples/profile_step`` at the flagship row (its JSON
   line: top kernels, wall and device ms, busy share, the resets' and
   threefry's share), threefry launched 8 times a step by the reset; (h)
   ``examples/profile_ppo`` at ppo_train_step_mlp_bf16 (its JSON line).
   The profiler must see ``crossing_cast_kernel`` in (a), (c) and (g).
10. the single-env Game API (``Game.reset_single``, ``step_single``,
   ``observe_single``), each family's reset (the player then placed facing
   its goal) plus 64 steps of seeded actions, the first three forward,
   re-reset from ``state.rng_key`` on ``done``: under ``auto``
   (the crossing cast at [1, R]) against ``crossing`` and under ``pallas``
   (the DDA cast) against ``scan``, for SingleRoom at the reference default
   (8x16, 512 rays x 256 px), the other families at the JAX bench rows'
   widths and MultiPlayerRoom at 2 players; under ``fused`` (the DDA + u32
   render kernel, camera_u32 and camera_gray) against ``scan`` for
   SingleRoom, DynamicRoom and LockedRoom; under ``crossing_kernel_fused``
   (the crossing + pal8 render kernel) in camera_pal8 against ``crossing``
   for SingleRoom and RandomRoom.  Each run: the expected kernel launched
   once per observation and no other kernel, by the wrappers' counts and
   by the profiler's trace; states and frames equal to the plain run on the
   card and to the CPU run; states equal to row k of an 8-env
   ``reset_batch``/``step_batch`` run on the card with the same keys and
   actions; ms per single-env step on the card and on the CPU.  Then
   ``cast_rays_pallas`` (the DDA kernel at [1, 512]) equal to
   ``cast_rays_scan``.  Each kernel's B=1 shape joins the kernels' rows.
11. the port bench (``raycastworlds_tpu_torch.bench``, ``bench_ppo``):
   (a) every ``SUITE`` row through ``bench.run_one`` at its own widths, 8
   steps and one rep: ``auto`` resolved to ``crossing_kernel`` (the named
   kernel for ``config3_pal8_kernel`` and ``ref_default_pal8_kernel_4096``),
   its kernel launched once per observation made (both players of
   MultiPlayerRoom in one launch) and no other kernel, a positive rate and
   a finite checksum; (b) each row again under the plain ``crossing`` from
   the same keys, and the CLI's ``--raycast pallas`` and ``fused`` at the
   flagship and reference-default widths against ``scan``: checksums and
   final states identical bit for bit, so all four kernels equal their
   plain versions through the bench's own entry; (c) ``run_ppo_row`` for
   the three PPO rows at full width (``crossing_cast`` once per
   observation, every loss finite), then ``run_suite`` over two rows and
   one PPO row (one JSON line, ``summary`` last, no ``error``); (d)
   ``python -m raycastworlds_tpu_torch.bench_ppo`` once per variant
   (defaults, ``--trunk mlp --dtype bfloat16 --phases``, ``--recurrent
   --game maze``, ``--game multi_player``, ``--mesh`` at one rank; 16
   rollout steps, one timed update), each printing its JSON line.

The card's name and power limit are printed again before the kernels'
JSON record, which is the line before the last: each kernel's
launches summed over the main paths (and the PPO rows, phase 8's runs on
every rank and phase 9's, 10's and 11's runs) that route through it, its numbers at
the reference-default shape and, under ``shapes``, at every main-path
shape with its launches per step, then the threefry kernel's (its
launches summed over the same runs, its numbers at SingleRoom's 4096-env
main path and, under ``shapes``, at every path of phase 3's rows), and
last the flood fill kernel's (its launches summed over the same runs, its
numbers at the budgeted reset's [256, 16, 16] and, under ``shapes``, at
each of phase 3's flood rows); the last line is ``{"ok": true, "device":
{...}}``.  Any failure raises: there is
no fallback, and a machine without a CUDA device, or a directory without
the package, exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
STEPS = 64
PROFILED_LAUNCHES = 60
TRACE_DIR = os.path.join(ROOT, "raycastworlds_tpu_torch", "_build", "traces")
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, float32 outside the
# tensor cores in operations/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float operations per grid line crossed: the crossing distance, the cross
# coordinate's multiply and add, and the compare
OPS_PER_CROSSING = 4
# name -> (source, the Pallas body it replaces)
KERNELS = {
    "crossing_cast": ("raycastworlds_tpu_torch/csrc/crossing_cast.cu",
                      "raycastworlds_tpu/ops/raycast_crossing_kernel.py:113"),
    "crossing_render_pal8": ("raycastworlds_tpu_torch/csrc/crossing_render_pal8.cu",
                             "raycastworlds_tpu/ops/raycast_crossing_kernel.py:175"),
    "dda_cast": ("raycastworlds_tpu_torch/csrc/dda_cast.cu",
                 "raycastworlds_tpu/ops/raycast_pallas.py:30"),
    "dda_render_u32": ("raycastworlds_tpu_torch/csrc/dda_render_u32.cu",
                       "raycastworlds_tpu/ops/render_fused.py:62"),
}
# The threefry hash's kernel, which replaces no Pallas kernel (jax.random's
# threefry is XLA's, fused into one op there); integer operations of the
# hash per element (20 rounds of add, rotate and xor, 5 key injections of 3
# adds, 3 to set up: the counter's index arithmetic, which an unsharded draw
# does not need, is left out); the H100 SXM's int32 issue rate, 64 lanes a
# clock per SM x 132 SMs x 1.98 GHz
THREEFRY = ("raycastworlds_tpu_torch/csrc/threefry.cu",
            "none: jax.random's threefry, which XLA fuses into one op")
THREEFRY_OPS = 78
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# the threefry kernel's launches in the runs whose other kernels' launches
# main() sums (phases 5 and 7-11): read just before and just after each
MAIN_THREEFRY = [0]
# The reachability fill's kernel, which replaces no Pallas kernel (the JAX
# package's fill is a fori_loop of dilations that XLA fuses); its launches
# in the same runs as MAIN_THREEFRY
FLOOD = ("raycastworlds_tpu_torch/csrc/flood_fill.cu",
         "none: the JAX package's flood_fill, a fori_loop of dilations that XLA fuses")
MAIN_FLOOD = [0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def launch_counts() -> dict:
    """name -> the kernel's launches in this process so far (the tracer's
    ``kernel_launches.<name>``, counted by ``cuda_build.launch``), for
    KERNELS, threefry and flood_fill."""
    from raycastworlds_tpu_torch.utils import profiling

    return {name: profiling.total(f"kernel_launches.{name}")
            for name in (*KERNELS, "threefry", "flood_fill")}


def launches_since(before: dict, main_run: bool = False) -> dict:
    """name -> each of KERNELS' launches since ``launch_counts()`` read
    ``before``.  ``main_run``: the window is a main-path run whose launches
    main() sums, and threefry's and flood_fill's launches in it are added
    to MAIN_THREEFRY and MAIN_FLOOD."""
    now = launch_counts()
    if main_run:
        MAIN_THREEFRY[0] += now["threefry"] - before["threefry"]
        MAIN_FLOOD[0] += now["flood_fill"] - before["flood_fill"]
    return {name: now[name] - before[name] for name in KERNELS}


def wrappers():
    """name -> the kernel's wrapper."""
    from raycastworlds_tpu_torch.ops import raycast_crossing_kernel as rck
    from raycastworlds_tpu_torch.ops import raycast_pallas, render_fused

    return {
        "crossing_cast": rck.cast_rays_crossing_kernel,
        "crossing_render_pal8": rck.cast_render_pal8_kernel,
        "dda_cast": raycast_pallas.cast_rays_pallas_batched,
        "dda_render_u32": render_fused.render_camera_fused_batched,
    }


# Input kinds of the kernel-vs-plain sets: "random" (interior positions,
# random unit rays, a border ring), "sliding" (integer positions, rays with
# an exact-zero component), "no_border" (random, no border ring: rays leave
# the map and the clamped tile repeats), "tiny" (random, one component of
# |d| in TINY, so that t overflows to +inf partway along that axis) and
# "corners" (integer positions, diagonal rays through tile corners).
AXES = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], np.float32)
_S = np.float32(np.sqrt(0.5))
DIAGONALS = np.array([[_S, _S], [-_S, _S], [-_S, -_S], [_S, -_S]], np.float32)
TINY = np.array([1e-30, 1e-37, 3e-38, 1e-39, 1e-44], np.float32)


def random_maps(rng, b, h, w, density, border=True):
    maps = rng.random((b, h, w)) < density
    if border:
        maps[:, 0, :] = maps[:, -1, :] = True
        maps[:, :, 0] = maps[:, :, -1] = True
    return maps


def signed_tiny(rng, shape):
    return TINY[rng.integers(0, len(TINY), size=shape)] * rng.choice(
        np.array([-1, 1], np.float32), size=shape)


def fuzz_inputs(h, w, b, r, seed, device, kind="random"):
    """Packed random maps (interior walls at density 0.25), positions and
    rays of ``kind`` (the kinds above), from numpy.random.default_rng(seed)."""
    import torch

    from raycastworlds_tpu_torch.ops.bitmap import pack_bits_np

    rng = np.random.default_rng(seed)
    maps = random_maps(rng, b, h, w, 0.25, border=kind != "no_border")
    words = pack_bits_np(maps).view(np.int32)
    if kind in ("sliding", "corners"):
        pos = rng.integers(1, [h - 1, w - 1], size=(b, 2)).astype(np.float32)
        # the old sliding set's order of axes, so that its rays stay as they were
        axes = AXES[[0, 2, 1, 3]] if kind == "sliding" else DIAGONALS
        dirs = axes[rng.integers(0, 4, size=(b, r))]
    else:
        pos = rng.uniform([1.0, 1.0], [h - 1.0, w - 1.0], size=(b, 2)).astype(np.float32)
        ang = rng.uniform(0.0, 2.0 * np.pi, size=(b, r))
        dirs = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
        if kind == "tiny":
            comp = rng.integers(0, 2, size=(b, r, 1))
            np.put_along_axis(dirs, comp, signed_tiny(rng, (b, r, 1)), axis=-1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return t(words), t(pos), t(dirs)


def render_inputs(h, w, b, r, hpu, seed, device, kind="random"):
    """Inputs of the fused render kernels as a SingleRoom-like world gives
    them: random walls (density 0.25) inside a border, block tiles on 15%
    of the other tiles, a goal tile on an empty interior tile (obstacles =
    walls | blocks | goal), random interior positions and headings, each
    heading's player direction and mirror-ordered ray fan (R rays, 128
    headings), and the render constants.  Other ``kind``s:
    "sliding", integer positions, axis headings with exact axis player
    directions, and the first 8 rays of every fan along the heading (an
    exact-zero component); "no_border", no border ring; "tiny", axis
    headings whose first 8 rays have a TINY perpendicular component;
    "corners", integer positions and diagonal headings whose first 8 rays
    run along the diagonal."""
    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.ops import render
    from raycastworlds_tpu_torch.ops.bitmap import pack_bits_np

    cfg = rt.EnvConfig(height_tile_map_tu=h, width_tile_map_tu=w, num_rays=r,
                       height_camera_view_pu=hpu)
    rng = np.random.default_rng(seed)
    walls = random_maps(rng, b, h, w, 0.25, border=kind != "no_border")
    goal = rng.integers(1, [h - 1, w - 1], size=(b, 2)).astype(np.int32)
    walls[np.arange(b), goal[:, 0], goal[:, 1]] = False
    blocks = (rng.random((b, h, w)) < 0.15) & ~walls
    blocks[np.arange(b), goal[:, 0], goal[:, 1]] = False
    obst = walls | blocks
    obst[np.arange(b), goal[:, 0], goal[:, 1]] = True
    if kind in ("sliding", "corners", "tiny"):
        if kind == "tiny":
            pos = rng.uniform([1.0, 1.0], [h - 1.0, w - 1.0], size=(b, 2))
        else:
            pos = rng.integers(1, [h - 1, w - 1], size=(b, 2))
        pos = pos.astype(np.float32)
        q = rng.integers(0, 4, size=b)
        dir_au = q * (cfg.num_directions // 4)
        if kind == "corners":
            dir_au = dir_au + cfg.num_directions // 8
            pdir = cfg.directions_wu[dir_au]
        else:
            pdir = AXES[q]
        dirs = cfg.ray_fan_lut_flipped[dir_au].copy()
        dirs[:, :8] = pdir[:, None, :]
        if kind == "tiny":  # the component across the heading: 1 for q even
            dirs[np.arange(b)[:, None], np.arange(8), (1 - q % 2)[:, None]] = (
                signed_tiny(rng, (b, 8)))
    else:
        pos = rng.uniform([1.0, 1.0], [h - 1.0, w - 1.0], size=(b, 2)).astype(np.float32)
        dir_au = rng.integers(0, cfg.num_directions, size=b)
        pdir = cfg.directions_wu[dir_au]
        dirs = cfg.ray_fan_lut_flipped[dir_au]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    num, denom = render.render_constants(cfg)
    return dict(
        obstacle_words=t(pack_bits_np(obst).view(np.int32)),
        wall_words=t(pack_bits_np(walls).view(np.int32)),
        block_words=t(pack_bits_np(blocks).view(np.int32)),
        shape=(h, w), pos=t(pos), pdir=t(pdir), dirs=t(dirs), goal=t(goal),
        hpu=hpu, num=num, denom=denom,
    )


def max_err(got, want) -> float:
    """Max abs difference over the outputs; raises unless all are equal."""
    import torch

    errs = [0.0 if torch.equal(g, w) else float((g.double() - w.double()).abs().max())
            for g, w in zip(got, want)]
    return max(errs)


def kernel_vs_plain(name, label, kernel, plain) -> float:
    """Run the kernel and its plain version on the same inputs; require
    every output equal; return the max abs error (0)."""
    import torch

    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max_err(got, want)
    check(err == 0.0 and all(torch.equal(g, w) for g, w in zip(got, want)),
          f"{name} != plain at {label}: max err {err}")
    return err


def compare_crossing(h, w, b, r, seed, device, kind="random") -> float:
    from raycastworlds_tpu_torch.ops import raycast_crossing_kernel as rck

    words, pos, dirs = fuzz_inputs(h, w, b, r, seed, device, kind)
    return kernel_vs_plain(
        "crossing_cast", f"{h}x{w} B={b} R={r} {kind}",
        lambda: rck.cast_rays_crossing_kernel(words, (h, w), pos, dirs),
        lambda: rck.cast_rays_crossing_kernel_ref(words, (h, w), pos, dirs),
    )


def compare_dda(h, w, b, r, seed, device, kind="random", max_steps=None) -> float:
    from raycastworlds_tpu_torch.ops import raycast, raycast_pallas

    words, pos, dirs = fuzz_inputs(h, w, b, r, seed, device, kind)
    steps = h + w if max_steps is None else max_steps
    return kernel_vs_plain(
        "dda_cast", f"{h}x{w} B={b} R={r} {kind} steps={steps}",
        lambda: raycast_pallas.cast_rays_pallas_batched(words, (h, w), pos, dirs, steps),
        lambda: raycast.cast_rays_scan(words, (h, w), pos, dirs, steps),
    )


def compare_pal8(h, w, b, r, hpu, seed, device, kind="random") -> float:
    from raycastworlds_tpu_torch.ops import raycast_crossing_kernel as rck

    x = render_inputs(h, w, b, r, hpu, seed, device, kind)
    args = (x["obstacle_words"], x["shape"], x["pos"], x["dirs"], x["pdir"],
            x["goal"], hpu, x["num"], x["denom"])
    return kernel_vs_plain(
        "crossing_render_pal8", f"{h}x{w} B={b} R={r} hpu={hpu} {kind}",
        lambda: rck.cast_render_pal8_kernel(*args),
        lambda: rck.cast_render_pal8_kernel_ref(*args),
    )


def compare_fused(h, w, b, r, hpu, seed, device, kind="random", max_steps=None,
                  blocks=False) -> float:
    from raycastworlds_tpu_torch.ops import render_fused

    x = render_inputs(h, w, b, r, hpu, seed, device, kind)
    steps = h + w if max_steps is None else max_steps
    args = (x["obstacle_words"], x["wall_words"], x["shape"], x["pos"], x["pdir"],
            x["dirs"], steps, hpu, x["num"], x["denom"],
            x["block_words"] if blocks else None)
    return kernel_vs_plain(
        "dda_render_u32",
        f"{h}x{w} B={b} R={r} hpu={hpu} {kind} steps={steps} blocks={blocks}",
        lambda: render_fused.render_camera_fused_batched(*args),
        lambda: render_fused.render_camera_fused_batched_ref(*args),
    )


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


def device_ms(name, fn, launches: int = PROFILED_LAUNCHES, reduce=np.median) -> float:
    """Median (or ``reduce``) device time of one launch of kernel ``name``
    (the CUDA function ``{name}_kernel``), from torch.profiler's CUDA
    activity over ``launches`` calls of ``fn`` after a warm-up.  The profiler can drop
    kernel records from a window; windows are repeated (at most 5) until
    ``launches`` durations are in.  The last trace is kept under
    TRACE_DIR."""
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
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        durs += [e["dur"] for e in events
                 if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel"
                 and f"{name}_kernel" in e.get("name", "")]
        if len(durs) >= launches:
            return float(reduce(durs)) / 1e3
    raise RuntimeError(f"chip_smoke check failed: the profiler saw {len(durs)} launches "
                       f"of {name}_kernel in 5 windows of {launches}")


def plains():
    """name -> the kernel's plain PyTorch version (the wrapper's arguments)."""
    from raycastworlds_tpu_torch.ops import raycast, render_fused
    from raycastworlds_tpu_torch.ops import raycast_crossing_kernel as rck

    return {
        "crossing_cast": rck.cast_rays_crossing_kernel_ref,
        "crossing_render_pal8": rck.cast_render_pal8_kernel_ref,
        "dda_cast": raycast.cast_rays_scan,
        "dda_render_u32": render_fused.render_camera_fused_batched_ref,
    }


def work(name, args, kwargs, out):
    """(bytes, operations) that one call of kernel ``name`` on these inputs
    needs: every tensor argument read once and every output written once;
    OPS_PER_CROSSING float operations for each grid line a ray crosses up
    to its hit in this data (counted by the plain scan), plus 2 compares per
    pixel of a render."""
    import torch

    from raycastworlds_tpu_torch.ops import raycast

    tensors = [x for x in list(args) + list(kwargs.values()) if torch.is_tensor(x)]
    outs = out if isinstance(out, tuple) else (out,)
    nbytes = sum(x.numel() * x.element_size() for x in tensors + list(outs))
    if name in ("crossing_cast", "dda_cast"):
        words, shape, pos, dirs = args[:4]
        pixels = 0
    elif name == "crossing_render_pal8":
        words, shape, pos, dirs = args[:4]
        pixels = out.numel()
    else:
        words, shape, pos, dirs = args[0], args[2], args[3], args[5]
        pixels = out.numel()
    hit_tu, _, _ = raycast.cast_rays_scan(words, shape, pos, dirs, sum(shape))
    start = torch.floor(pos).to(torch.int64)[:, None, :]
    crossings = int((hit_tu.to(torch.int64) - start).abs().sum())
    return nbytes, OPS_PER_CROSSING * crossings + 2 * pixels


def measure(name, label, args, kwargs=None) -> dict:
    """Kernel ``name`` against its plain version on (args, kwargs), exact;
    then its device ms per launch (device_ms), its wrapper's host ms per
    call (time_ms over 20 calls), the plain version's ms, and the bound of
    the work (the larger of its bytes over HBM_BYTES_PER_S and its
    operations over FP32_OPS_PER_S)."""
    kwargs = kwargs or {}
    kernel = lambda: wrappers()[name](*args, **kwargs)  # noqa: E731
    plain = lambda: plains()[name](*args, **kwargs)  # noqa: E731
    err = kernel_vs_plain(name, label, kernel, plain)
    dev = device_ms(name, kernel)
    host = time_ms(kernel, 20)
    plain_ms = time_ms(plain, 3)
    nbytes, ops = work(name, args, kwargs, kernel())
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    row = dict(kernel=name, shape=label, max_abs_err=err, device_ms=dev, ms=host,
               plain_ms=plain_ms, bytes=nbytes, ops=ops, bound_ms=max(by_bytes, by_ops),
               bound_by="bytes" if by_bytes >= by_ops else "operations")
    row["bound_share"] = row["bound_ms"] / dev
    print(f"{name} at {label}: kernel == plain; device {dev:.4f} ms per launch (profiler "
          f"median of >= {PROFILED_LAUNCHES}), wrapper {host:.4f} ms per call, plain "
          f"{plain_ms:.4f} ms; bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
          f"({nbytes} B, {ops} ops), share of bound {row['bound_share']:.3f}")
    return row


def reference_rows(device) -> dict:
    """measure() of every kernel at the reference-default shape (4096 envs x
    512 rays x 256 px, 8x16, density-0.25 fuzz maps), the row kept since the
    first slice; name -> row."""
    words, pos, dirs = fuzz_inputs(8, 16, 4096, 512, SEED, device)
    x = render_inputs(8, 16, 4096, 512, 256, SEED, device)
    args = {
        "crossing_cast": (words, (8, 16), pos, dirs),
        "dda_cast": (words, (8, 16), pos, dirs, 24),
        "crossing_render_pal8": (x["obstacle_words"], x["shape"], x["pos"], x["dirs"],
                                 x["pdir"], x["goal"], 256, x["num"], x["denom"]),
        "dda_render_u32": (x["obstacle_words"], x["wall_words"], x["shape"], x["pos"],
                           x["pdir"], x["dirs"], 24, 256, x["num"], x["denom"]),
    }
    return {name: measure(name, "reference default 8x16 B=4096 R=512 hpu 256 (fuzz maps)",
                          args[name])
            for name in KERNELS}


class plain_rng:
    """Within ``with plain_rng():`` every draw takes the plain path
    (``rng.threefry2x32``), on the card too."""

    def __enter__(self):
        from raycastworlds_tpu_torch import rng

        self.real = rng._uses_kernel
        rng._uses_kernel = lambda key: False

    def __exit__(self, *exc):
        from raycastworlds_tpu_torch import rng

        rng._uses_kernel = self.real


class recorded_hashes:
    """Within ``with recorded_hashes() as seen:`` every hash the kernel
    computes is recorded in the dict ``seen`` once per (keys' leading
    shape, geometry, pair): a copy of its first keys, the geometry and
    pair."""

    def __enter__(self):
        from raycastworlds_tpu_torch import rng

        self.real, seen = rng._hash_kernel, {}

        def recording(key, g, pair):
            seen.setdefault((tuple(key.shape[:-1]), g, pair), (key.clone(), g, pair))
            return self.real(key, g, pair)

        rng._hash_kernel = recording
        return seen

    def __exit__(self, *exc):
        from raycastworlds_tpu_torch import rng

        rng._hash_kernel = self.real


def threefry_total() -> int:
    """The threefry kernel's launches in this process so far."""
    from raycastworlds_tpu_torch.utils import profiling

    return profiling.total("kernel_launches.threefry")


def plain_hash(key, g, pair):
    """The hash of geometry ``g`` through the rng draw it comes from: a lone
    element at counter ``g.start`` > 0 is ``fold_in``, any other the draw of
    the global shape (and shard and axis) that ``g`` describes; on the path
    that the key's device and ``plain_rng`` pick."""
    from raycastworlds_tpu_torch import rng

    n = int(np.prod(g.local, dtype=np.int64))
    if g.local == () and g.start:
        check(pair, f"threefry: a lone counter {g.start} hashed without pair")
        return rng.fold_in(key, g.start)
    if g.inner == 1 and g.start == 0 and g.local_len == g.global_len == n:
        return rng._hash(key, g.local, pair=pair)
    for axis, size in enumerate(g.local):
        if size == g.local_len and int(np.prod(g.local[axis + 1:], dtype=np.int64)) == g.inner:
            shape = g.local[:axis] + (g.global_len,) + g.local[axis + 1:]
            return rng._hash(key, shape, (g.start, g.start + g.local_len), axis, pair)
    raise RuntimeError(f"chip_smoke check failed: no draw has the geometry {g}")


def hash_row(label, hashes, launches_per_step) -> dict:
    """The recorded ``hashes`` of one path: each the kernel's against the
    plain path's on the card and on the CPU, exact, one launch each; then
    replayed together, the kernel's mean device ms per launch (device_ms),
    the wrapper's host ms per hash (time_ms over 20 replays), the plain
    path's ms per hash, and the mean bound of a hash (the larger of its
    bytes, keys read and outputs written, over HBM_BYTES_PER_S and of
    THREEFRY_OPS an element over INT32_OPS_PER_S)."""
    import torch

    from raycastworlds_tpu_torch import rng

    kernel = lambda: [rng._hash_kernel(k, g, pair) for k, g, pair in hashes]  # noqa: E731
    plain = lambda: [plain_hash(k, g, pair) for k, g, pair in hashes]  # noqa: E731
    before = threefry_total()
    got = kernel()
    torch.cuda.synchronize()
    n = threefry_total() - before
    check(n == len(hashes), f"threefry at {label}: {n} launches for {len(hashes)} hashes")
    with plain_rng():
        want = plain()
    for (k, g, pair), a, b in zip(hashes, got, want):
        what = f"threefry at {label}: {len(k.shape) - 1}-d keys {tuple(k.shape[:-1])}, {g}"
        check(torch.equal(a, b), f"{what}: kernel != plain on the card")
        check(torch.equal(a.cpu(), plain_hash(k.cpu(), g, pair)), f"{what}: card != CPU")
    dev = device_ms("threefry", kernel, reduce=np.mean)
    host = time_ms(kernel, 20) / len(hashes)
    with plain_rng():
        plain_ms = time_ms(plain, 3) / len(hashes)
    nbytes = ops = 0
    by_bytes = by_ops = bound = 0.0
    for k, g, pair in hashes:
        keys, elems = k[..., 0].numel(), int(np.prod(g.local, dtype=np.int64))
        b = keys * (16 + elems * (16 if pair else 8))
        o = keys * elems * THREEFRY_OPS
        nbytes, ops = nbytes + b, ops + o
        by_bytes, by_ops = by_bytes + b / HBM_BYTES_PER_S * 1e3, by_ops + o / INT32_OPS_PER_S * 1e3
        bound += max(b / HBM_BYTES_PER_S, o / INT32_OPS_PER_S) * 1e3
    row = dict(kernel="threefry", shape=label, launches_per_step=launches_per_step,
               max_abs_err=0.0, device_ms=dev, ms=host, plain_ms=plain_ms, bytes=nbytes,
               ops=ops, bound_ms=bound / len(hashes),
               bound_by="bytes" if by_bytes >= by_ops else "operations")
    row["bound_share"] = row["bound_ms"] / dev
    per_step = "" if launches_per_step is None else f"{launches_per_step:g} launches per step; "
    print(f"threefry at {label}: {len(hashes)} distinct hashes, kernel == plain == CPU, one "
          f"launch each; {per_step}device {dev:.4f} ms per launch (profiler mean), wrapper "
          f"{host:.4f} ms per hash, plain {plain_ms:.4f} ms per hash; bound "
          f"{row['bound_ms']:.6f} ms a hash, mostly by {row['bound_by']} ({nbytes} B, {ops} "
          f"ops), share of bound {row['bound_share']:.4f}")
    return row


THREEFRY_PATHS = ("auto camera_u32", "random_room camera_rgb", "maze camera_u32",
                  "dynamic_room fused", "locked_room fused", "multi_goal pallas",
                  "multi_player camera_u32")
THREEFRY_STEPS = 4


def threefry_rows(device) -> list:
    """hash_row() of each main path's own draws: the hashes of a reset and
    THREEFRY_STEPS steps (actions drawn before) of each family's main path
    in THREEFRY_PATHS at its batch, with the launches per step read over
    the steps (SingleRoom's must be the reset's 8); of a train step of each
    PPO row after its init, with the launches per env step read over the
    train step; and of rank 1's sharded draws in phase 8's dp = 2 mesh of
    MESH_ENVS envs, its rows [MESH_ENVS / 2, MESH_ENVS) (``shard_range``):
    ``Env.reset``'s split, the throughput program's actions (axis 1) and
    the policy's categorical."""
    import dataclasses

    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch import rng

    rows = []
    for label, game, cfg, num_envs, backend, _, _, kw in main_paths():
        if label not in THREEFRY_PATHS:
            continue
        env = rt.Env(game(dataclasses.replace(cfg, raycast_backend=backend)),
                     num_envs=num_envs, device=device, reset_budget=kw.get("reset_budget", 0))
        actions = rng.randint(rng.PRNGKey(SEED + 1, device),
                              (THREEFRY_STEPS, num_envs) + env.game.action_shape, 0,
                              env.game.num_actions)
        with recorded_hashes() as seen:
            state, _ = env.reset(rng.PRNGKey(SEED, device))
            before = threefry_total()
            for a in actions:
                state = env.step(state, a).state
            torch.cuda.synchronize()
            per_step = (threefry_total() - before) / THREEFRY_STEPS
        if game is rt.SingleRoom:
            check(per_step == 8, f"threefry at {label}: {per_step} launches per step, not 8")
        rows.append(hash_row(f"{label}: {game.__name__} B={num_envs}, reset + "
                             f"{THREEFRY_STEPS} steps", list(seen.values()), per_step))
        del env, state, actions, seen
    for row in PPO_ROWS:
        trainer = ppo_trainer(row, device)
        with recorded_hashes() as seen:
            ts = trainer.init(rng.PRNGKey(SEED))
            before = threefry_total()
            ts, metrics = trainer.train_step(ts)
            float(metrics["loss"])
            per_step = (threefry_total() - before) / trainer.cfg.rollout_steps
        rows.append(hash_row(f"{row}: B={trainer.env.num_envs}, init + a train step",
                             list(seen.values()), per_step))
        del trainer, ts, seen
    start, stop = MESH_ENVS // 2, MESH_ENVS
    logits = torch.zeros(stop - start, 4, device=device)
    with recorded_hashes() as seen:
        rng.split(rng.PRNGKey(SEED, device), MESH_ENVS, (start, stop))
        rng.randint(rng.PRNGKey(SEED + 1, device), (MESH_ENV_STEPS, MESH_ENVS), 0, 4,
                    (start, stop), axis=1)
        rng.categorical(rng.PRNGKey(SEED + 2, device), logits, (start, stop))
    rows.append(hash_row(f"mesh dp=2 rank 1: rows [{start}, {stop}) of {MESH_ENVS}",
                         list(seen.values()), None))
    return rows


def threefry_record(rows) -> dict:
    """The threefry kernel's entry of the kernels' JSON: its launches in the
    runs whose other launches main() sums (MAIN_THREEFRY), and its rows
    (the first, SingleRoom's 4096-env main path, as the headline)."""
    first = rows[0]
    return {
        "name": "threefry", "route": "cuda", "source": THREEFRY[0], "replaces": THREEFRY[1],
        "launches": MAIN_THREEFRY[0], "max_abs_err": 0.0, "library_ms": None,
        **{k: first[k] for k in ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by",
                                 "bound_share")},
        "shapes": [{k: r[k] for k in ("shape", "launches_per_step", "device_ms", "ms",
                                      "plain_ms", "bound_ms", "bound_share")} for r in rows],
    }


class recorded_fills:
    """Within ``with recorded_fills() as seen:`` the first fill the kernel
    computes at each (map shape, dilations) is recorded in the dict
    ``seen``: copies of its map and seeds, and its dilations."""

    def __enter__(self):
        from raycastworlds_tpu_torch.ops import flood

        self.real, seen = flood._flood_fill_kernel, {}

        def recording(passable, seed_tu, num_iters):
            seen.setdefault((tuple(passable.shape), num_iters),
                            (passable.clone(), seed_tu.clone(), num_iters))
            return self.real(passable, seed_tu, num_iters)

        flood._flood_fill_kernel = recording
        return seen

    def __exit__(self, *exc):
        from raycastworlds_tpu_torch.ops import flood

        flood._flood_fill_kernel = self.real


def fixed_point_dilations(passable, seed_tu) -> int:
    """The dilations after which every env's fill stops changing (the
    plain loop's, read on the host after each)."""
    import torch

    from raycastworlds_tpu_torch.ops import flood

    reach, k = flood.flood_fill_plain(passable, seed_tu, 0), 0
    while True:
        nxt = flood.dilate4(reach) & passable
        if torch.equal(nxt, reach):
            return k
        reach, k = nxt, k + 1


def fill_row(label, passable, seed_tu, num_iters, launches_per_step) -> dict:
    """The flood fill kernel on one recorded fill: equal to the plain path
    on the card and on the CPU, exact, in one launch; the kernel's median
    device ms per launch (device_ms), the wrapper's host ms per call
    (time_ms over 20 calls), the plain path's ms, and the bound: the bytes
    of the bool map read, the int32 seeds read and the bool result written,
    over HBM_BYTES_PER_S (the rounds' few integer operations a 32-tile word
    are far below it)."""
    import torch

    from raycastworlds_tpu_torch.ops import flood
    from raycastworlds_tpu_torch.utils import profiling

    kernel = lambda: flood._flood_fill_kernel(passable, seed_tu, num_iters)  # noqa: E731
    plain = lambda: flood.flood_fill_plain(passable, seed_tu, num_iters)  # noqa: E731
    before = profiling.total("kernel_launches.flood_fill")
    got = kernel()
    torch.cuda.synchronize()
    n = profiling.total("kernel_launches.flood_fill") - before
    check(n == 1, f"flood fill at {label}: {n} launches for one fill")
    check(torch.equal(got, plain()), f"flood fill at {label}: kernel != plain on the card")
    check(torch.equal(got.cpu(), flood.flood_fill_plain(passable.cpu(), seed_tu.cpu(),
                                                        num_iters)),
          f"flood fill at {label}: card != CPU")
    rounds = fixed_point_dilations(passable, seed_tu)
    dev = device_ms("flood_fill", kernel)
    host = time_ms(kernel, 20)
    plain_ms = time_ms(plain, 3)
    nbytes = 2 * passable.numel() + seed_tu.numel() * 4
    row = dict(kernel="flood_fill", shape=label, launches_per_step=launches_per_step,
               max_abs_err=0.0, device_ms=dev, ms=host, plain_ms=plain_ms, bytes=nbytes,
               ops=0, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    row["bound_share"] = row["bound_ms"] / dev
    per_step = "" if launches_per_step is None else f"{launches_per_step:g} launches per step; "
    print(f"flood fill at {label}: kernel == plain == CPU in one launch, {num_iters} "
          f"dilations, fixed point after {rounds}; {per_step}device {dev:.4f} ms per launch "
          f"(profiler median of >= {PROFILED_LAUNCHES}), wrapper {host:.4f} ms per call, "
          f"plain {plain_ms:.4f} ms; bound {row['bound_ms']:.6f} ms by bytes ({nbytes} B), "
          f"share of bound {row['bound_share']:.4f}")
    return row


def flood_rows(device) -> list:
    """fill_row() of RandomRoom's own fills: those of a reset and
    THREEFRY_STEPS steps of the ``random_room camera_rgb`` main path (8192
    envs, budget 256), one launch a reset; the budgeted reset's shape
    first."""
    import dataclasses

    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch import rng
    from raycastworlds_tpu_torch.utils import profiling

    label, game, cfg, num_envs, backend, _, _, kw = next(
        p for p in main_paths() if p[0] == "random_room camera_rgb")
    env = rt.Env(game(dataclasses.replace(cfg, raycast_backend=backend)), num_envs=num_envs,
                 device=device, reset_budget=kw["reset_budget"])
    actions = rng.randint(rng.PRNGKey(SEED + 1, device), (THREEFRY_STEPS, num_envs), 0,
                          env.game.num_actions)
    with recorded_fills() as seen:
        state, _ = env.reset(rng.PRNGKey(SEED, device))
        before = profiling.total("kernel_launches.flood_fill")
        for a in actions:
            state = env.step(state, a).state
        torch.cuda.synchronize()
        per_step = (profiling.total("kernel_launches.flood_fill") - before) / THREEFRY_STEPS
    check(per_step == 1, f"flood fill at {label}: {per_step} launches per step, not 1")
    rows = []
    for (shape, iters), (passable, seed_tu, _) in sorted(seen.items()):
        first = shape[0] == num_envs
        rows.append(fill_row(
            f"{label}: RandomRoom {'first reset' if first else 'budgeted reset'} "
            f"{list(shape)}", passable, seed_tu, iters, None if first else per_step))
    del env, state, actions, seen
    return rows


def flood_record(rows) -> dict:
    """The flood fill kernel's entry of the kernels' JSON: its launches in
    the runs whose other launches main() sums (MAIN_FLOOD), and its rows
    (the first, the budgeted reset's, as the headline)."""
    first = rows[0]
    return {
        "name": "flood_fill", "route": "cuda", "source": FLOOD[0], "replaces": FLOOD[1],
        "launches": MAIN_FLOOD[0], "max_abs_err": 0.0, "library_ms": None,
        **{k: first[k] for k in ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by",
                                 "bound_share")},
        "shapes": [{k: r[k] for k in ("shape", "launches_per_step", "device_ms", "ms",
                                      "plain_ms", "bound_ms", "bound_share")} for r in rows],
    }


def observed_inputs(name, game, num_envs, device):
    """(args, kwargs) with which ``game.observe_batch`` of a fresh
    ``reset_batch`` of ``num_envs`` envs (keys split from SEED) calls the
    wrapper of kernel ``name``."""
    import raycastworlds_tpu_torch as rt

    fn = wrappers()[name]
    module = sys.modules[fn.__module__]
    calls = []

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, fn.__name__, record)
    try:
        keys = rt.rng.split(rt.rng.PRNGKey(SEED, device), num_envs)
        game.observe_batch(game.reset_batch(keys))
    finally:
        setattr(module, fn.__name__, fn)
    check(len(calls) == 1, f"{name}: observe_batch called its wrapper {len(calls)} times")
    return calls[0]


def shape_rows(device, paths, launches=None) -> list:
    """measure() of each main path's kernel at that path's shape, on the
    inputs its observe_batch hands the kernel after a reset (observed_inputs);
    ``launches``: the path's launches per step (per observation), by label."""
    import dataclasses

    rows = []
    for label, game, cfg, num_envs, backend, kernel, _, _ in paths:
        if kernel is None:
            continue
        g = game(dataclasses.replace(cfg, raycast_backend=backend))
        args, kwargs = observed_inputs(kernel, g, num_envs, device)
        players = getattr(cfg, "num_players", 1)
        shape = (f"{label}: {cfg.H}x{cfg.W} B={num_envs * players}"
                 + (f" ({num_envs} envs x {players} players)" if players > 1 else "")
                 + f" R={cfg.num_rays}"
                 + ("" if kernel.endswith("cast") else f" hpu {cfg.height_camera_view_pu}"))
        row = measure(kernel, shape, args, kwargs)
        if launches is not None:
            row["launches_per_step"] = launches[label]
        rows.append(row)
        del args, kwargs
    return rows


def kernel_phase(device) -> dict:
    """Every kernel against its plain version on every fuzz input set.
    Returns {name: [max abs err of each set]}."""
    maps = ((13, 9), (24, 40), (48, 48))
    errs = {name: [] for name in KERNELS}
    errs["crossing_cast"].append(compare_crossing(8, 16, 4096, 512, SEED, device))
    errs["dda_cast"].append(compare_dda(8, 16, 4096, 512, SEED, device))
    errs["crossing_render_pal8"].append(compare_pal8(8, 16, 4096, 512, 256, SEED, device))
    errs["dda_render_u32"].append(compare_fused(8, 16, 4096, 512, 256, SEED, device))
    errs["dda_render_u32"].append(
        compare_fused(8, 16, 4096, 512, 256, SEED + 9, device, blocks=True))
    for h, w in maps:
        errs["crossing_cast"].append(compare_crossing(h, w, 512, 512, SEED + h, device))
        errs["dda_cast"].append(compare_dda(h, w, 512, 512, SEED + h, device))
        errs["crossing_render_pal8"].append(compare_pal8(h, w, 512, 512, 256, SEED + h, device))
        for blocks in (False, True):
            errs["dda_render_u32"].append(
                compare_fused(h, w, 512, 512, 256, SEED + h, device, blocks=blocks))
    for (h, w, r), seed in (((8, 16, 512), SEED + 1), ((24, 40, 333), SEED + 2)):
        errs["crossing_cast"].append(compare_crossing(h, w, 256, r, seed, device, "sliding"))
        errs["dda_cast"].append(compare_dda(h, w, 256, r, seed, device, "sliding"))
    for (h, w, r, hpu), seed in (((8, 16, 513, 256), SEED + 3), ((24, 40, 333, 100), SEED + 4)):
        errs["crossing_render_pal8"].append(
            compare_pal8(h, w, 256, r, hpu, seed, device, "sliding"))
        errs["dda_render_u32"].append(
            compare_fused(h, w, 256, r, hpu, seed, device, "sliding", blocks=True))
    errs["dda_cast"].append(compare_dda(8, 16, 512, 512, SEED + 5, device, max_steps=3))
    errs["dda_cast"].append(compare_dda(24, 40, 256, 333, SEED + 6, device, "sliding",
                                        max_steps=3))
    for blocks in (False, True):
        errs["dda_render_u32"].append(compare_fused(8, 16, 512, 512, 256, SEED + 7, device,
                                                    max_steps=3, blocks=blocks))
    # the crossing cast's block layouts (envs x rays): 4 envs of 1 ray, 1
    # env of 80 rays in a 96-thread block, and a 336x336 map at 2 rays,
    # whose 4 envs' words exceed shared memory (2 envs per block instead)
    for (h, w, b, r), seed in (((8, 16, 256, 1), 17), ((8, 16, 256, 80), 18),
                               ((336, 336, 64, 2), 19)):
        errs["crossing_cast"].append(compare_crossing(h, w, b, r, SEED + seed, device))
        errs["dda_cast"].append(compare_dda(h, w, b, r, SEED + seed, device))
    # the sets an early-exit walk has to survive, at the main paths' maps
    for i, kind in enumerate(("no_border", "tiny", "corners")):
        for (h, w, r), seed in (((8, 16, 512), 20), ((16, 16, 256), 21), ((17, 17, 64), 22),
                                ((24, 40, 333), 23)):
            errs["crossing_cast"].append(
                compare_crossing(h, w, 512, r, SEED + seed + 10 * i, device, kind))
            errs["dda_cast"].append(compare_dda(h, w, 512, r, SEED + seed + 10 * i, device, kind))
        for (h, w, r, hpu), seed in (((8, 16, 512, 256), 24), ((16, 16, 256, 128), 25),
                                     ((8, 16, 64, 64), 26)):
            errs["crossing_render_pal8"].append(
                compare_pal8(h, w, 512, r, hpu, SEED + seed + 10 * i, device, kind))
    for name, e in errs.items():
        print(f"{name}: kernel == plain on {len(e)} fuzz input sets (max abs err {max(e)})")
    return errs


def golden_frame(game, device) -> np.ndarray:
    """tests/test_golden_images.py's frame: first of seeds (1234, 7, 42, 99)
    with >= 3 colours after reset and actions 2, 0, 3."""
    import torch

    import raycastworlds_tpu_torch as rt

    for seed in (1234, 7, 42, 99):
        state = game.reset_batch(rt.rng.PRNGKey(seed, device)[None])
        for a in (2, 0, 3):
            state = game.step_batch(state, torch.full(
                (1,) + game.action_shape, a, dtype=torch.int32, device=device))
        frame = game.observe_batch(state)[0].cpu().numpy()
        if len(np.unique(frame)) >= 3:
            return frame
    raise RuntimeError("no structural golden frame found")


def golden_phase(device) -> None:
    """The golden frames "single_room", its checker, brick and xor textured
    twins, "multi_player" and "top_view", each through the crossing kernel,
    equal to tests/data/golden_frames.npz (the port's CPU frames equal them
    too, tests/test_torch_golden.py)."""
    import raycastworlds_tpu_torch as rt
    golden = np.load(os.path.join(ROOT, "tests", "data", "golden_frames.npz"))
    games = {
        "single_room": rt.SingleRoom(rt.EnvConfig(num_rays=64, height_camera_view_pu=48)),
        **{f"single_room_{tex}": rt.SingleRoom(rt.EnvConfig(
            num_rays=64, height_camera_view_pu=48, wall_texture=tex, texture_cells=8))
           for tex in ("checker", "brick", "xor")},
        "multi_player": rt.MultiPlayerRoom(rt.MultiPlayerConfig(
            num_players=2, num_rays=64, height_camera_view_pu=48)),
        "top_view": rt.SingleRoom(rt.EnvConfig(num_rays=32, pu_per_tu=8, obs_type="top_u32")),
    }
    for name, game in games.items():
        before = launch_counts()
        frame = golden_frame(game, device)
        check(launches_since(before)["crossing_cast"] > 0,
              f"golden frame {name} did not go through the kernel")
        check(frame.dtype == golden[name].dtype and np.array_equal(frame, golden[name]),
              f"golden frame {name} differs from tests/data/golden_frames.npz")
        print(f"golden frame {name} {frame.shape} matches through the kernel")


def top_view_phase(device, num_envs=256) -> None:
    """top_u32 observations of SingleRoom (the reference default's 512 rays)
    and MultiPlayerRoom (the main path's config) after a reset and 3 random
    steps on the card: equal to the same states' on the CPU; prints the
    card's ms per call (CUDA events, 5 calls)."""
    import torch

    import raycastworlds_tpu_torch as rt

    for label, game in (
        ("SingleRoom", rt.SingleRoom(rt.EnvConfig(obs_type="top_u32"))),
        ("MultiPlayerRoom", rt.MultiPlayerRoom(multi_player_cfg(obs_type="top_u32"))),
    ):
        state = game.reset_batch(rt.rng.split(rt.rng.PRNGKey(SEED, device), num_envs))
        for q in range(3):
            a = rt.rng.randint(rt.rng.PRNGKey(SEED + q, device),
                               (num_envs,) + game.action_shape, 0, 4)
            state = game.step_batch(state, a)
        got = game.observe_batch(state)
        want = game.observe_batch(state.to("cpu"))
        check(got.shape == (num_envs,) + game.cfg.obs_shape and got.dtype == torch.uint32,
              f"top view {label}: obs {tuple(got.shape)} {got.dtype}")
        check(torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)),
              f"top view {label}: the card's top_u32 differs from the CPU's")
        ms = time_ms(lambda: game.observe_batch(state), 5)
        print(f"top view {label} {tuple(got.shape)} at {num_envs} envs: card == CPU; "
              f"{ms:.2f} ms per call on the card")


def pal8_decode_phase(device, num_envs=4096) -> None:
    """Textured camera_pal8 frames (the reference default at ``num_envs``
    envs after a reset and 3 random steps, cast by the crossing kernel)
    decoded through ``cfg.palette_np`` equal the camera_u32 frames of the
    same states, for the checker, brick and xor textures."""
    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.ops import render

    for tex in ("checker", "brick", "xor"):
        cfg = rt.EnvConfig(wall_texture=tex, obs_type="camera_pal8",
                           raycast_backend="crossing_kernel_fused")
        game = rt.SingleRoom(cfg)
        state = game.reset_batch(rt.rng.split(rt.rng.PRNGKey(SEED, device), num_envs))
        for q in range(3):
            state = game.step_batch(state, rt.rng.randint(
                rt.rng.PRNGKey(SEED + q, device), (num_envs,), 0, 4))
        pal8 = game.observe_batch(state)
        u32 = game.camera_view_batch(state)
        decoded = render.pal8_to_u32(pal8, cfg.palette_np)
        check(torch.equal(decoded.view(torch.int32), u32.view(torch.int32)),
              f"{tex}: decoded pal8 frames differ from the camera_u32 frames")
        print(f"textured pal8 {tex} {tuple(pal8.shape)}: decodes through its "
              f"{len(cfg.palette_np)}-entry palette to the camera_u32 frames of the same "
              f"states ({int(pal8.max())} the largest index)")
        del pal8, u32, decoded


def profile_step(label, game, cfg, num_envs, device, steps=5) -> dict:
    """Wall ms per step (host clock around ``steps`` synchronized steps
    after 3 warm-up steps), device ms per step (the sum of the CUDA
    kernels' durations in torch.profiler's trace of the same steps), the
    device's busy share (device / wall) and kernels per step, of
    ``Env(game(cfg))`` with random actions."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import raycastworlds_tpu_torch as rt

    env = rt.Env(game(cfg), num_envs=num_envs, device=device)
    state, _ = env.reset(rt.rng.PRNGKey(SEED))
    acts = rt.rng.randint(rt.rng.PRNGKey(SEED + 2, device),
                          (steps + 3, num_envs) + env.game.action_shape, 0, 4)
    for a in acts[:3]:
        state = env.step(state, a).state
    torch.cuda.synchronize()
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, "step_" + label.replace(" ", "_") + ".json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for a in acts[3:]:
            state = env.step(state, a).state
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    prof.export_chrome_trace(path)
    with open(path) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel"]
    dev = sum(e["dur"] for e in kernels) / 1e3 / steps
    row = dict(path=label, envs=num_envs, wall_ms=wall, device_ms=dev, busy=dev / wall,
               kernels_per_step=len(kernels) / steps)
    check(dev > 0, f"profile {label}: the trace holds no kernel")
    print(f"profile {label}, {num_envs} envs, {steps} steps under torch.profiler: wall "
          f"{wall:.2f} ms/step, device {dev:.2f} ms/step, busy {row['busy']:.1%}, "
          f"{row['kernels_per_step']:.1f} kernels/step")
    return row


def count_budgeted_resets(env):
    """Make ``env.step`` add, on the device, the envs its budgeted reset
    re-initialized (needy before the step and not pending after it) to
    ``env.resets``, and the envs left pending to ``env.frozen``."""
    import torch

    env.resets = torch.zeros((), dtype=torch.int64, device=env.device)
    env.frozen = torch.zeros((), dtype=torch.int64, device=env.device)
    step = env.step

    def counted(state, action):
        res = step(state, action)
        env.resets += ((state.pending_reset | res.done) & ~res.state.pending_reset).sum()
        env.frozen += res.state.pending_reset.sum()
        return res

    env.step = counted


def run_main_path(game, cfg, num_envs, steps, device, reset_budget=0):
    """Reset + ``steps`` steps of the throughput program of
    ``Env(game(cfg))``; returns (final state, checksum, obs of the reset,
    seconds of the steps, (budgeted resets, frozen env-steps) or None).  The
    timed region ends on the host read of the checksum."""
    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.parallel import rollout

    env = rt.Env(game(cfg), num_envs=num_envs, device=device, reset_budget=reset_budget)
    if reset_budget:
        count_budgeted_resets(env)
    state, obs = env.reset(rt.rng.PRNGKey(SEED))
    run = rollout.steps_per_second_program(env, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, acc = run(state, rt.rng.PRNGKey(SEED + 1))
    checksum = float(acc)
    seconds = time.perf_counter() - t0
    budget = (int(env.resets), int(env.frozen)) if reset_budget else None
    return state, checksum, obs, seconds, budget


def same_state(a, b) -> bool:
    import torch

    return all(torch.equal(x, b.leaves()[k]) for k, x in a.leaves().items())


def main_path_phase(label, game, cfg, num_envs, device, kernel_backend, kernel, plains,
                    turns=True, reset_budget=0, memory=False) -> dict:
    """The kernel path against each plain path on one card: kernel, the
    plains, the plains again in reverse and the kernel again (``turns``),
    or kernel then plains.  Every count is read just before the first
    kernel run and just after it: ``kernel`` must have launched once
    per observation made and every other kernel never (``kernel`` None: no
    kernel at all).  Every run must end in the first run's state and
    checksum; for ``kernel`` None (the analytic cast, whose distances are
    not bit-exact with the crossing's) the checksums must agree to 1e-6
    relative and the reset frames on 99.9% of their values.  A budgeted
    phase must reset envs through its budget.  ``memory``: print the peak
    device memory of the kernel run.  Returns the launches of the first
    run, by kernel."""
    import dataclasses

    import torch

    kcfg = dataclasses.replace(cfg, raycast_backend=kernel_backend)
    if memory:
        torch.cuda.reset_peak_memory_stats(device)
    before = launch_counts()
    k_state, k_sum, obs, k_s, budget = run_main_path(
        game, kcfg, num_envs, STEPS, device, reset_budget)
    launches = launches_since(before, main_run=True)
    if memory:
        print(f"main path {label}: peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    want = {name: (STEPS + 1 if name == kernel else 0) for name in KERNELS}
    check(launches == want,
          f"{label}: kernel launches {launches} for {STEPS + 1} observations, "
          f"expected {want}")
    check(tuple(obs.shape) == (num_envs,) + cfg.obs_shape,
          f"{label}: obs shape {tuple(obs.shape)}")
    check(math.isfinite(k_sum), f"{label}: checksum {k_sum}")
    if reset_budget:
        check(budget[0] > 0, f"{label}: the reset budget reset no env")
    order = list(plains) + (list(plains)[::-1] + [kernel_backend] if turns else [])
    rates = [(kernel_backend, num_envs * STEPS / k_s)]
    sums = [(kernel_backend, k_sum)]
    for backend in order:
        st, sm, p_obs, s, p_budget = run_main_path(
            game, dataclasses.replace(cfg, raycast_backend=backend), num_envs, STEPS,
            device, reset_budget)
        check(same_state(st, k_state) and p_budget == budget,
              f"{label}: {backend} path final state differs")
        if kernel is None:
            as_i32 = lambda x: x.view(torch.int32) if x.dtype == torch.uint32 else x  # noqa: E731
            equal = float((as_i32(p_obs) == as_i32(obs)).to(torch.float32).mean())
            check(abs(sm - k_sum) <= 1e-6 * abs(sm) and equal >= 0.999,
                  f"{label}: {backend} checksum {sm} vs {k_sum}, reset frames "
                  f"{equal:.6f} equal")
        else:
            check(sm == k_sum, f"{label}: {backend} checksum differs ({sm} vs {k_sum})")
        rates.append((backend, num_envs * STEPS / s))
        sums.append((backend, sm))
    agree = ("checksums " + ", ".join(f"{b} {x!r}" for b, x in sums)
             if kernel is None else f"checksum {k_sum!r} (all paths equal)")
    print(f"main path {label}: {num_envs} envs x {STEPS} steps, obs "
          f"{tuple(obs.shape)} {obs.dtype}, {agree}, "
          + (f"{kernel} launches {launches[kernel]}" if kernel else "no kernel launched"))
    if reset_budget:
        print(f"main path {label}: budget {reset_budget} reset {budget[0]} envs, "
              f"{budget[1]} env-steps frozen awaiting a reset (every path)")
    print(f"main path {label} env-steps/s in run order: "
          + ", ".join(f"{b} {x:.1f}" for b, x in rates))
    return launches


def plain_path_phase(label, cfg, device, num_envs=4096, small=64, steps=16) -> None:
    """A config that no kernel takes: SingleRoom ``cfg`` at ``num_envs``
    envs, reset plus STEPS steps of the throughput program, launches no
    kernel (every count read just before and just after); then at
    ``small`` envs over ``steps`` random steps the card's states and frames
    equal the CPU's, exactly."""
    import torch

    import raycastworlds_tpu_torch as rt

    before = launch_counts()
    state, checksum, obs, seconds, _ = run_main_path(rt.SingleRoom, cfg, num_envs, STEPS,
                                                     device)
    launches = launches_since(before)
    check(not any(launches.values()), f"{label}: kernels launched {launches}")
    check(tuple(obs.shape) == (num_envs,) + cfg.obs_shape and math.isfinite(checksum),
          f"{label}: obs {tuple(obs.shape)}, checksum {checksum}")
    envs = [rt.Env(rt.SingleRoom(cfg), num_envs=small, device=d) for d in (device, "cpu")]
    runs = [e.reset(rt.rng.PRNGKey(SEED)) for e in envs]
    as_i32 = lambda x: x.view(torch.int32) if x.dtype == torch.uint32 else x  # noqa: E731
    for q in range(steps + 1):
        (gs, go), (cs, co) = runs
        check(same_state(gs.to("cpu"), cs) and torch.equal(as_i32(go).cpu(), as_i32(co)),
              f"{label}: the card's state or frame differs from the CPU's at step {q}")
        if q < steps:
            a = rt.rng.randint(rt.rng.PRNGKey(SEED + q), (small,), 0, 4)
            runs = [(r.state, r.obs) for r in (e.step(s, a) for e, (s, _) in zip(envs, runs))]
    print(f"plain path {label}: {num_envs} envs x {STEPS} steps, obs {tuple(obs.shape)} "
          f"{obs.dtype}, pos {state.pos_wu.dtype}, heading {state.dir_au.dtype}, no kernel "
          f"launched, checksum {checksum!r}, {num_envs * STEPS / seconds:.1f} env-steps/s; "
          f"card == CPU at {small} envs over {steps} steps")


def large_map_phase(device, num_envs=64, steps=4) -> None:
    """``auto`` keeps a map whose packed words exceed the kernel's shared
    memory off the kernel: the Python cap equals the built library's, and a
    640x640 SingleRoom (12,800 words) resolves to the plain crossing cast
    and steps on the card without a launch."""
    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch import config, cuda_build

    cap = cuda_build.load().rcw_max_smem_words()
    check(config.KERNEL_MAX_WORDS == cap,
          f"KERNEL_MAX_WORDS {config.KERNEL_MAX_WORDS} != rcw_max_smem_words() {cap}")
    cfg = rt.EnvConfig(height_tile_map_tu=640, width_tile_map_tu=640, num_rays=64,
                       height_camera_view_pu=64)
    check(cfg.resolved_raycast_backend(device.type) == "crossing",
          "auto takes a kernel for a 640x640 map")
    before = launch_counts()
    env = rt.Env(rt.SingleRoom(cfg), num_envs=num_envs, device=device)
    state, obs = env.reset(rt.rng.PRNGKey(SEED))
    for q in range(steps):
        res = env.step(state, env.sample_action(rt.rng.PRNGKey(SEED + q)))
        state, obs = res.state, res.obs
    torch.cuda.synchronize()
    launches = launches_since(before)
    check(not any(launches.values()), f"large map: kernels launched {launches}")
    check(tuple(obs.shape) == (num_envs, 64, 64), f"large map: obs {tuple(obs.shape)}")
    print(f"large map 640x640 ({-(-640 * 640 // 32)} words > cap {cap}): auto -> crossing, "
          f"{num_envs} envs x {steps} steps on the card, no kernel launched")


def multi_player_cfg(**kw):
    """The MultiPlayerRoom main path's config, the JAX bench row
    multi_player_2p_4096 (2 players, sprites, 64 rays x 64 px), with ``kw``."""
    import raycastworlds_tpu_torch as rt

    return rt.MultiPlayerConfig(num_rays=64, height_camera_view_pu=64, **kw)


def main_paths():
    """(label, family, config, envs, kernel backend, kernel, plain backends,
    options of main_path_phase) of every main path."""
    import raycastworlds_tpu_torch as rt

    u32, pal8 = rt.EnvConfig(), rt.EnvConfig(obs_type="camera_pal8")
    room = dict(height_tile_map_tu=16, width_tile_map_tu=16, num_rays=256,
                height_camera_view_pu=128)
    small = dict(num_rays=64, height_camera_view_pu=64)
    return [
        ("auto camera_u32", rt.SingleRoom, u32, 4096, "auto", "crossing_cast",
         ["crossing"], dict(turns=False)),
        ("fused camera_u32", rt.SingleRoom, u32, 4096, "fused", "dda_render_u32",
         ["scan"], {}),
        ("pallas camera_u32", rt.SingleRoom, u32, 4096, "pallas", "dda_cast", ["scan"], {}),
        ("crossing_kernel_fused camera_pal8", rt.SingleRoom, pal8, 4096,
         "crossing_kernel_fused", "crossing_render_pal8", ["crossing", "crossing_kernel"], {}),
        ("auto camera_pal8", rt.SingleRoom, pal8, 1024, "auto", "crossing_cast",
         ["crossing"], dict(turns=False)),
        ("random_room camera_rgb", rt.RandomRoom,
         rt.RandomRoomConfig(**room, obs_type="camera_rgb"), 8192, "auto", "crossing_cast",
         ["crossing"], dict(turns=False, reset_budget=256)),
        ("random_room camera_pal8", rt.RandomRoom,
         rt.RandomRoomConfig(**room, obs_type="camera_pal8"), 8192,
         "crossing_kernel_fused", "crossing_render_pal8", ["crossing", "crossing_kernel"],
         dict(reset_budget=256)),
        ("maze camera_u32", rt.Maze, rt.MazeConfig(**small), 32768, "auto", "crossing_cast",
         ["crossing"], dict(turns=False, reset_budget=512)),
        ("dynamic_room fused", rt.DynamicRoom, rt.DynamicRoomConfig(**small), 8192,
         "fused", "dda_render_u32", ["scan"], {}),
        ("locked_room fused", rt.LockedRoom, rt.LockedRoomConfig(**small), 8192,
         "fused", "dda_render_u32", ["scan"], {}),
        ("multi_goal pallas", rt.MultiGoalRoom, rt.MultiGoalConfig(**small), 8192,
         "pallas", "dda_cast", ["scan"], {}),
        ("multi_goal analytic", rt.MultiGoalRoom, rt.MultiGoalConfig(**small), 8192,
         "analytic", None, ["crossing"], dict(turns=False)),
        ("multi_player camera_u32", rt.MultiPlayerRoom, multi_player_cfg(), 4096, "auto",
         "crossing_cast", ["crossing"], dict(turns=False)),
        ("multi_player block pallas", rt.MultiPlayerRoom,
         multi_player_cfg(player_render="block"), 4096, "pallas", "dda_cast", ["scan"], {}),
        ("multi_player camera_pal8", rt.MultiPlayerRoom,
         multi_player_cfg(obs_type="camera_pal8"), 4096, "crossing_kernel_fused",
         "crossing_cast", ["crossing"], {}),
        ("checker camera_u32", rt.SingleRoom, rt.EnvConfig(wall_texture="checker"), 4096,
         "auto", "crossing_cast", ["crossing"], dict(turns=False, memory=True)),
        ("brick camera_u32", rt.SingleRoom, rt.EnvConfig(wall_texture="brick"), 4096,
         "pallas", "dda_cast", ["scan"], dict(turns=False)),
        ("xor camera_pal8", rt.SingleRoom,
         rt.EnvConfig(wall_texture="xor", texture_cells=8, obs_type="camera_pal8"), 4096,
         "crossing_kernel_fused", "crossing_cast", ["crossing"], dict(turns=False)),
    ]


# The JAX bench's PPO rows (bench.py:405-415, run_ppo_row :324-384):
# SingleRoom at 64 rays x 64 px under ``auto`` (the crossing cast kernel on
# the card), the mlp trunk of hidden 256 in bfloat16, rollout 64, 4
# minibatches.  name -> (obs type, envs, epochs, recurrent)
PPO_ROWS = {
    "ppo_train_step_mlp_bf16": ("camera_gray", 2048, 2, False),
    "ppo_train_step_throughput": ("camera_gray_u8", 4096, 1, False),
    "ppo_train_step_recurrent_gru": ("camera_gray", 2048, 2, True),
}
PPO_TIMED_UPDATES = 2


def ppo_trainer(row, device, dtype=None, backend="auto"):
    """The trainer of PPO row ``row`` on ``device`` (compute ``dtype``,
    bfloat16 by default; ``backend`` the raycast backend)."""
    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.parallel.ppo import PPOConfig, PPOTrainer
    from raycastworlds_tpu_torch.parallel.ppo_rnn import RecurrentPPOTrainer

    obs, envs, epochs, recurrent = PPO_ROWS[row]
    cfg = rt.EnvConfig(num_rays=64, height_camera_view_pu=64, obs_type=obs,
                       raycast_backend=backend)
    env = rt.Env(rt.SingleRoom(cfg), num_envs=envs, device=device)
    cls = RecurrentPPOTrainer if recurrent else PPOTrainer
    return cls(env, PPOConfig(rollout_steps=STEPS, num_epochs=epochs), hidden=256,
               dtype=dtype or torch.bfloat16, trunk="mlp")


def observations_per_update(trainer) -> int:
    """The observations one train step makes, each one cast: the rollout's
    first, one per step, and for the feedforward trainer the bootstrap's
    observation of the final state (the GRU trainer bootstraps from the last
    step's observation)."""
    from raycastworlds_tpu_torch.parallel.ppo_rnn import RecurrentPPOTrainer

    return trainer.cfg.rollout_steps + (1 if isinstance(trainer, RecurrentPPOTrainer) else 2)


def time_phases(trainer, keep_rollout=False):
    """Wrap the trainer's two phases: each call appends its milliseconds
    (host clock between CUDA synchronisations) to ``trainer.phase_ms``
    ["rollout"] or ["update"]; ``keep_rollout`` keeps the last rollout
    phase's output as ``trainer.rollout``."""
    import torch

    trainer.phase_ms = {"rollout": [], "update": []}
    for phase in ("rollout", "update"):
        fn = getattr(trainer, f"_{phase}_phase")

        def timed(*args, _fn=fn, _phase=phase):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args)
            torch.cuda.synchronize()
            trainer.phase_ms[_phase].append((time.perf_counter() - t0) * 1e3)
            if keep_rollout and _phase == "rollout":
                trainer.rollout = out
            return out

        setattr(trainer, f"_{phase}_phase", timed)


def ppo_row_phase(row, device) -> dict:
    """PPO row ``row`` at full width: ``init``, one warm-up ``train_step``
    and PPO_TIMED_UPDATES timed ones (the timed region ends on the host read
    of the last metrics).  Every count is read just before ``init`` and
    after the last step: ``crossing_cast`` must have launched once per
    observation (the reset's, then observations_per_update per step) and
    no other kernel at all.  The metrics and params must be finite and every
    param tensor must have moved.  Prints env-steps/s, the two phases' ms
    and the peak device memory."""
    import torch

    import raycastworlds_tpu_torch as rt

    trainer = ppo_trainer(row, device)
    time_phases(trainer)
    torch.cuda.reset_peak_memory_stats(device)
    before = launch_counts()
    ts0 = trainer.init(rt.rng.PRNGKey(SEED))
    ts, metrics = trainer.train_step(ts0)
    float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(PPO_TIMED_UPDATES):
        ts, metrics = trainer.train_step(ts)
    metrics = {k: float(v) for k, v in metrics.items()}
    seconds = time.perf_counter() - t0
    launches = launches_since(before, main_run=True)
    per_update = observations_per_update(trainer)
    updates = 1 + PPO_TIMED_UPDATES
    want = {name: (1 + updates * per_update if name == "crossing_cast" else 0)
            for name in KERNELS}
    check(launches == want, f"{row}: kernel launches {launches} for 1 + {updates} x "
                            f"{per_update} observations, expected {want}")
    check(all(math.isfinite(v) for v in metrics.values()), f"{row}: metrics {metrics}")
    check(all(bool(torch.isfinite(v).all()) for v in ts.params.values()),
          f"{row}: params not finite")
    still = [k for k in ts.params if torch.equal(ts.params[k], ts0.params[k])]
    check(not still, f"{row}: params that did not move: {still}")
    check(ts.update_count == updates and ts.opt_state["count"] == updates * (
        trainer.cfg.num_epochs * trainer.cfg.num_minibatches), f"{row}: update counts")
    envs, steps = trainer.env.num_envs, trainer.cfg.rollout_steps
    out = dict(
        row=row, envs=envs, launches=launches["crossing_cast"],
        per_step=(launches["crossing_cast"] - 1) / (updates * steps),
        env_steps_per_s=envs * steps * PPO_TIMED_UPDATES / seconds,
        step_ms=seconds * 1e3 / PPO_TIMED_UPDATES,
        rollout_ms=trainer.phase_ms["rollout"][-PPO_TIMED_UPDATES:],
        update_ms=trainer.phase_ms["update"][-PPO_TIMED_UPDATES:],
        peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
    )
    print(f"ppo {row}: {envs} envs x {steps} steps, {trainer.env.cfg.obs_type}, "
          f"{type(trainer).__name__} mlp hidden 256 bfloat16, {trainer.cfg.num_epochs} "
          f"epochs x {trainer.cfg.num_minibatches} minibatches; crossing_cast launches "
          f"{out['launches']} (1 + {updates} x {per_update}), no other kernel; loss "
          f"{metrics['loss']!r}, entropy {metrics['entropy']!r}; "
          f"{out['env_steps_per_s']:.1f} env-steps/s through the train step "
          f"({out['step_ms']:.1f} ms per update), rollout ms "
          + ", ".join(f"{x:.1f}" for x in out["rollout_ms"]) + "; update ms "
          + ", ".join(f"{x:.1f}" for x in out["update_ms"])
          + f"; peak device memory {out['peak_gib']:.2f} GiB")
    return out


def ppo_kernel_vs_plain(device, row="ppo_train_step_mlp_bf16") -> float:
    """One train step of ``row``'s trainer in float32 through the crossing
    cast kernel (``auto``) and through the plain crossing cast, from the
    same key: the trajectories (actions, rewards, dones) and the final env
    states must be identical and the params after the update within 1e-5 of
    each tensor's largest magnitude.  Returns that largest relative
    difference."""
    import torch

    import raycastworlds_tpu_torch as rt

    runs = {}
    for backend in ("auto", "crossing"):
        trainer = ppo_trainer(row, device, torch.float32, backend)
        time_phases(trainer, keep_rollout=True)
        ts, metrics = trainer.train_step(trainer.init(rt.rng.PRNGKey(SEED)))
        traj = trainer.rollout[1]
        runs[backend] = (ts, traj.action, traj.reward, traj.done,
                         {k: float(v) for k, v in metrics.items()})
        del trainer, traj
    (k_ts, *k_traj, k_m), (p_ts, *p_traj, p_m) = runs["auto"], runs["crossing"]
    check(all(torch.equal(a, b) for a, b in zip(k_traj, p_traj)),
          f"{row} float32: the kernel and plain trajectories differ")
    check(same_state(k_ts.env_state, p_ts.env_state),
          f"{row} float32: the kernel and plain final env states differ")
    err = max(float((k_ts.params[k] - p_ts.params[k]).abs().max()
                    / p_ts.params[k].abs().max()) for k in p_ts.params)
    check(err <= 1e-5, f"{row} float32: params after the update differ by {err}")
    print(f"ppo {row} in float32 (TF32 off): kernel (auto) and plain (crossing) train "
          f"steps from one key: identical actions, rewards, dones "
          f"({int(k_traj[2].sum())} episode ends) and final env states; params within "
          f"{err:.3g} relative; loss {k_m['loss']!r} vs {p_m['loss']!r}")
    return err


def ppo_profile(device, row="ppo_train_step_mlp_bf16") -> dict:
    """One train step of ``row`` (after a warm-up) under torch.profiler:
    wall ms (host clock to the synchronised end, profiler overhead
    included), device ms (the sum of the CUDA activities' durations), the
    device's busy share and the device activities per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import raycastworlds_tpu_torch as rt

    trainer = ppo_trainer(row, device)
    ts, metrics = trainer.train_step(trainer.init(rt.rng.PRNGKey(SEED)))
    float(metrics["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts, metrics = trainer.train_step(ts)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev = sum(e.time_range.elapsed_us() for e in device_events) / 1e3
    check(dev > 0, f"profile {row}: the trace holds no device activity")
    out = dict(row=row, wall_ms=wall, device_ms=dev, busy=dev / wall,
               activities=len(device_events))
    print(f"profile ppo {row}, one train step under torch.profiler: wall {wall:.1f} ms, "
          f"device {dev:.1f} ms, busy {out['busy']:.1%}, {len(device_events)} device "
          f"activities (kernels, copies, fills) per step")
    return out


def ppo_layers(device, row="ppo_train_step_mlp_bf16", reps=5) -> dict:
    """Host ms per call of each layer of ``row``'s feedforward train step
    at its full width, each alone between CUDA synchronisations (mean of
    ``reps`` calls after one warm-up): in the rollout, ``Env.step`` (its
    observation's cast and render included), the policy's forward, the
    action sampling (``rng.categorical`` and the log-prob) and the key
    split; after it, GAE over the [64, B] rollout; in the update, one
    epoch's ``rng.permutation``, one minibatch's loss forward and backward,
    and one clipped Adam update."""
    import torch
    from torch.func import functional_call

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.parallel import ppo

    trainer = ppo_trainer(row, device)
    ts = trainer.init(rt.rng.PRNGKey(SEED))
    env, net, cfg = trainer.env, trainer.net, trainer.cfg
    key = ts.key
    obs = env.game.observe_batch(ts.env_state)
    x = ppo.preprocess_obs(env.cfg, obs)
    with torch.no_grad():
        logits, _ = functional_call(net, ts.params, (x,))
    action = rt.rng.categorical(key, logits)
    n = env.num_envs * cfg.rollout_steps
    mb = n // cfg.num_minibatches
    gen = torch.Generator(device=device).manual_seed(SEED)
    batch = {
        "obs": obs.repeat(mb // env.num_envs, 1, 1),
        "action": torch.randint(0, 4, (mb,), device=device, generator=gen),
        "log_prob": torch.full((mb,), -1.4, device=device),
        "advantage": torch.randn(mb, device=device, generator=gen),
        "target": torch.randn(mb, device=device, generator=gen),
    }
    t_b = (cfg.rollout_steps, env.num_envs)
    reward = torch.rand(t_b, device=device, generator=gen)
    value = torch.randn(t_b, device=device, generator=gen)
    done = torch.rand(t_b, device=device, generator=gen) < 0.01
    opt = ppo.Optimizer(ts.params, ts.opt_state, cfg)

    def loss_backward():
        loss, _ = ppo.ppo_loss(net, env.cfg, cfg, opt.params, batch)
        return torch.autograd.grad(loss, list(opt.params.values()))

    grads = loss_backward()

    def policy_forward():
        with torch.no_grad():
            functional_call(net, ts.params, (ppo.preprocess_obs(env.cfg, obs),))

    layers = {
        "env_step": lambda: env.step(ts.env_state, action),
        "policy_forward": policy_forward,
        "sampling": lambda: ppo.log_prob_of(torch.log_softmax(logits, -1),
                                            rt.rng.categorical(key, logits)),
        "key_split": lambda: rt.rng.split(key),
        "gae": lambda: ppo.compute_gae(reward, value, done, value[0], cfg.gamma,
                                       cfg.gae_lambda),
        "permutation": lambda: rt.rng.permutation(key, n),
        "minibatch_forward_backward": loss_backward,
        "adam_update": lambda: opt.apply(grads),
    }
    out = {}
    for name, fn in layers.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
    print(f"ppo {row} layers, host ms per call between synchronisations ({env.num_envs} "
          f"envs, minibatch {mb}): " + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def trainer_shape_rows(device, launches=None) -> list:
    """measure() of the crossing cast at the PPO rows' shapes ([2048, 64]
    and [4096, 64] on the 8x16 map), on the inputs observe_batch hands it
    after a reset; ``launches``: each row's launches per env step, as its
    phase 7 run counted them, by row."""
    import dataclasses

    import raycastworlds_tpu_torch as rt

    rows = []
    for row in ("ppo_train_step_mlp_bf16", "ppo_train_step_throughput"):
        obs, envs, _, _ = PPO_ROWS[row]
        cfg = rt.EnvConfig(num_rays=64, height_camera_view_pu=64, obs_type=obs)
        game = rt.SingleRoom(dataclasses.replace(cfg, raycast_backend="auto"))
        args, kwargs = observed_inputs("crossing_cast", game, envs, device)
        m = measure("crossing_cast", f"{row}: {cfg.H}x{cfg.W} B={envs} R=64", args, kwargs)
        if launches is not None:
            m["launches_per_step"] = launches[row]
        rows.append(m)
    return rows


# Phase 8: the mesh.  The PPO rows' widths (SingleRoom 64 rays x 64
# px camera_gray under ``auto``, mlp trunk of hidden 256, rollout 64, 4
# minibatches, 2 epochs) in float32 with TF32 off, so that topologies
# compare at float32.
MESH_ENVS = 4096           # global envs of the two- and four-rank runs
MESH_ONE_RANK_ENVS = 2048  # the one-rank NCCL run's
MESH_SHORT_ROLLOUT = 16    # the dp = 2 x mp = 2 step's rollout, cut to fit the time
MESH_ENV_STEPS = 16
# the budgeted RandomRoom row (phase 5's 8192 envs, budget 256) with every
# episode truncated at step 8, so that the budget's 256 resets per step walk
# across the dp = 2 shard boundary (env 4096) at step 24 of 32
MESH_BUDGET_STEPS = 32


def tf32_off() -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mesh_env(task, device, mesh=None):
    """The env of phase 8's env task ``task`` on ``device`` (or the mesh's)."""
    import raycastworlds_tpu_torch as rt

    if task == "env":
        cfg = rt.EnvConfig(num_rays=64, height_camera_view_pu=64, obs_type="camera_gray")
        return rt.Env(rt.SingleRoom(cfg), num_envs=MESH_ENVS,
                      device=None if mesh else device, mesh=mesh)
    cfg = rt.RandomRoomConfig(height_tile_map_tu=16, width_tile_map_tu=16, num_rays=256,
                              height_camera_view_pu=128, obs_type="camera_rgb",
                              max_episode_steps=8)
    return rt.Env(rt.RandomRoom(cfg), num_envs=8192, reset_budget=256,
                  device=None if mesh else device, mesh=mesh)


def mesh_env_task(task, device, mesh=None) -> dict:
    """Reset + the throughput program (``MESH_ENV_STEPS`` steps for
    ``"env"``, ``MESH_BUDGET_STEPS`` for ``"budget"``), every count read
    just before the reset and after the run: the assembled final state's leaves (numpy), the
    checksum, the budgeted resets and the launches."""
    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.parallel import mesh as mesh_lib
    from raycastworlds_tpu_torch.parallel import rollout

    env = mesh_env(task, device, mesh)
    if env.reset_budget:
        count_budgeted_resets(env)
    before = launch_counts()
    state, _ = env.reset(rt.rng.PRNGKey(SEED))
    steps = MESH_ENV_STEPS if task == "env" else MESH_BUDGET_STEPS
    state, acc = rollout.steps_per_second_program(env, steps)(state, rt.rng.PRNGKey(SEED + 1))
    checksum = float(acc)
    torch.cuda.synchronize()
    launches = launches_since(before, main_run=True)
    want = {name: (steps + 1 if name == "crossing_cast" else 0) for name in KERNELS}
    check(launches == want, f"mesh {task}: kernel launches {launches}, expected {want}")
    resets = getattr(env, "resets", None)
    if mesh is not None:
        state = mesh_lib.gather_env_state(state, mesh)
        if resets is not None:
            resets = mesh.sum(resets)
    return dict(state=state.to_numpy(), checksum=checksum, launches=launches["crossing_cast"],
                resets=None if resets is None else int(resets))


def mesh_trainer(task, device, num_envs, mesh=None):
    """The trainer of phase 8's train task ``task``: "ppo" and "gru" at the
    PPO rows' widths, "ppo16" the feedforward one with the short rollout."""
    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.parallel.ppo import PPOConfig, PPOTrainer
    from raycastworlds_tpu_torch.parallel.ppo_rnn import RecurrentPPOTrainer

    cfg = rt.EnvConfig(num_rays=64, height_camera_view_pu=64, obs_type="camera_gray")
    env = rt.Env(rt.SingleRoom(cfg), num_envs=num_envs, device=None if mesh else device,
                 mesh=mesh)
    rollout = MESH_SHORT_ROLLOUT if task == "ppo16" else STEPS
    cls = RecurrentPPOTrainer if task == "gru" else PPOTrainer
    return cls(env, PPOConfig(rollout_steps=rollout, num_epochs=2), hidden=256,
               dtype=torch.float32, trunk="mlp", mesh=mesh)


def first_minibatch(first: dict):
    """Make the feedforward update record, into ``first``, its first
    minibatch's loss (this rank's part) and its gradients as the optimizer
    clips them (averaged over dp; this rank's mp shards).  Returns the undo."""
    from raycastworlds_tpu_torch.parallel import ppo

    clip, loss_fn = ppo.clip_by_global_norm, ppo.ppo_loss

    def clip_first(grads, *args):
        first.setdefault("grads", [g.detach().clone() for g in grads])
        return clip(grads, *args)

    def loss_first(*args):
        out = loss_fn(*args)
        first.setdefault("loss", out[0].detach().clone())
        return out

    ppo.clip_by_global_norm, ppo.ppo_loss = clip_first, loss_first

    def undo():
        ppo.clip_by_global_norm, ppo.ppo_loss = clip, loss_fn

    return undo


def mesh_train_task(task, device, num_envs=None, mesh=None, nudge=False) -> dict:
    """``init`` and one train step of ``task``'s trainer, every count set to
    0 just before ``init``, then a second step timed (host clock between
    CUDA synchronisations, with the mesh's collectives and their host ms):
    the first step's assembled actions, rewards (feedforward), dones and
    final env state, the assembled params after it (numpy), this rank's
    params, whether each moved, the metrics and the launches (1 + 2 x the
    observations of one update).  For "ppo16" also the first minibatch's
    global loss and assembled gradients; ``nudge`` moves every element of
    ``trunk.weight`` one float32 ulp up before the step."""
    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.parallel import mesh as mesh_lib
    from raycastworlds_tpu_torch.parallel.ppo import gather_params

    trainer = mesh_trainer(task, device, num_envs or MESH_ENVS, mesh)
    time_phases(trainer, keep_rollout=True)
    before = launch_counts()
    ts0 = trainer.init(rt.rng.PRNGKey(SEED))
    if nudge:
        w = ts0.params["trunk.weight"]
        ts0 = ts0._replace(params=dict(ts0.params, **{
            "trunk.weight": torch.nextafter(w, torch.full_like(w, math.inf))}))
    first = {}
    undo = first_minibatch(first) if task == "ppo16" else (lambda: None)
    try:
        ts, metrics = trainer.train_step(ts0)
    finally:
        undo()
    if task == "gru":
        env_state, _, data, _ = trainer.rollout
        roll = {"action": data["action"], "done": data["done"]}
    else:
        env_state, traj = trainer.rollout[:2]
        roll = {"action": traj.action, "reward": traj.reward, "done": traj.done}
    trainer.rollout = None
    gather = (lambda x: x) if mesh is None else (lambda x: mesh.gather(x, dim=1))  # noqa: E731
    roll = {k: gather(v).cpu().numpy() for k, v in roll.items()}
    if mesh is not None:
        env_state = mesh_lib.gather_env_state(env_state, mesh)
    params = ts.params if mesh is None or task == "gru" else gather_params(ts.params, mesh)
    out = dict(
        roll=roll, env_state=env_state.to_numpy(),
        params={k: v.cpu().numpy() for k, v in params.items()},
        local={k: v.cpu().numpy() for k, v in ts.params.items()},
        still=[k for k in ts.params if torch.equal(ts.params[k], ts0.params[k])],
        metrics={k: float(v) for k, v in metrics.items()},
    )
    if first:
        grads = dict(zip(ts.params, first["grads"]))
        loss = first["loss"]
        if mesh is not None:
            grads, loss = gather_params(grads, mesh), mesh.mean(loss)
        out["first_grads"] = {k: v.cpu().numpy() for k, v in grads.items()}
        out["first_loss"] = float(loss)
    del ts0, first
    c0, ms0 = (mesh.collectives, mesh.collective_ms) if mesh is not None else (0, 0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, metrics = trainer.train_step(ts)
    float(metrics["loss"])
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    if mesh is not None:
        out["collectives"] = mesh.collectives - c0
        out["collective_ms"] = mesh.collective_ms - ms0
    launches = launches_since(before, main_run=True)
    per_update = observations_per_update(trainer)
    want = {name: (1 + 2 * per_update if name == "crossing_cast" else 0) for name in KERNELS}
    check(launches == want, f"mesh {task}: kernel launches {launches} for 1 + 2 x "
                            f"{per_update} observations, expected {want}")
    check(all(math.isfinite(v) for v in out["metrics"].values()),
          f"mesh {task}: metrics {out['metrics']}")
    check(not out["still"], f"mesh {task}: params that did not move: {out['still']}")
    out["launches"] = launches["crossing_cast"]
    return out


def mesh_rank(dp, mp, tasks) -> dict:
    """One rank of phase 8 (started by ``mesh.launch`` under gloo, every
    rank on ``cuda:0``): the (dp, mp) mesh, then each task.  Returns each
    task's result (numpy) and, under ``"threefry"``, the threefry kernel's
    launches in the tasks' runs."""
    import torch

    from raycastworlds_tpu_torch import cuda_build
    from raycastworlds_tpu_torch.parallel import mesh as mesh_lib

    check(not any(m.split(".")[0] == "jax" for m in sys.modules), "a rank imported JAX")
    tf32_off()
    cuda_build.load()  # built by the parent before any rank started
    world = torch.distributed.get_world_size()
    mesh = mesh_lib.make_mesh(dp=dp, mp=mp, devices=["cuda:0"] * world)
    out = {"mp_index": mesh.mp_index}
    threefry = MAIN_THREEFRY[0]
    for task in tasks:
        if task in ("env", "budget"):
            out[task] = mesh_env_task(task, None, mesh)
        else:
            out[task] = mesh_train_task(task.split("_")[0], None, MESH_ENVS, mesh,
                                        nudge=task.endswith("_nudged"))
    out["threefry"] = MAIN_THREEFRY[0] - threefry
    return out


def same_leaves(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def params_rel_err(got: dict, want: dict) -> float:
    """The largest difference of any param over that param's largest
    magnitude."""
    return max(float(np.abs(got[k].astype(np.float64) - want[k]).max() / np.abs(want[k]).max())
               for k in want)


def check_rollout(label, got, want) -> None:
    for k, w in want["roll"].items():
        diff = np.argwhere(got["roll"][k] != w)
        check(not diff.size, f"{label}: {k} differs from the one-process run at (t, env) "
                             f"{diff[:8].tolist()}")
    check(same_leaves(got["env_state"], want["env_state"]),
          f"{label}: the final env state differs from the one-process run")


def mesh_phase(device) -> int:
    """Phase 8: the mesh on the one card.  One rank under NCCL (dp = 1):
    the feedforward and GRU trainers with a mesh against the same trainers
    without one (2048 envs): identical rollouts, params within 1e-5.  Two
    ranks under gloo on CUDA tensors (dp = 2, 4096 global envs): reset + 16
    steps and the budgeted RandomRoom equal to the one-process card run
    bit for bit; one feedforward and one GRU train step whose rollout is
    the one-process run's, with replicated params bit-identical across
    ranks.  Four ranks (dp = 2 x mp = 2): one feedforward step at the short
    rollout whose gathered params are within 1e-4 of the dp = 2 run's.
    Every rank launches ``crossing_cast`` once per observation and no other
    kernel.  Prints each topology's ms per train step and the collectives'
    host ms per update; returns the crossing-cast launches of every run
    (each rank's threefry launches go to MAIN_THREEFRY)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from raycastworlds_tpu_torch.parallel import mesh as mesh_lib
    from raycastworlds_tpu_torch.parallel.ppo import param_shard_dim

    tf32_off()
    launches = 0
    os.makedirs(os.path.dirname(TRACE_DIR), exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="mesh_", dir=os.path.dirname(TRACE_DIR))

    # one rank, NCCL
    dist.init_process_group("nccl", init_method=f"file://{store_dir}/nccl", world_size=1,
                            rank=0)
    try:
        mesh = mesh_lib.make_mesh(dp=1, devices=[device])
        for task in ("ppo", "gru"):
            plain = mesh_train_task(task, device, MESH_ONE_RANK_ENVS)
            meshed = mesh_train_task(task, device, MESH_ONE_RANK_ENVS, mesh)
            launches += plain["launches"] + meshed["launches"]
            check_rollout(f"mesh {task} one rank", meshed, plain)
            err = params_rel_err(meshed["params"], plain["params"])
            check(err <= 1e-5, f"mesh {task} one rank: params differ by {err}")
            check(meshed["collectives"] > 0, f"mesh {task} one rank: no collective ran")
            print(f"mesh one rank (NCCL, dp=1, {MESH_ONE_RANK_ENVS} envs) {task}: rollout "
                  f"identical to the trainer without a mesh, params within {err:.3g}; "
                  f"ms per train step {meshed['step_ms']:.1f} (without a mesh "
                  f"{plain['step_ms']:.1f}); collectives per update {meshed['collectives']}, "
                  f"their host ms {meshed['collective_ms']:.2f}; crossing_cast launches "
                  f"{meshed['launches']}")
    finally:
        dist.destroy_process_group()

    # the one-process card runs the ranks are held against
    ref = {task: mesh_env_task(task, device) for task in ("env", "budget")}
    ref.update({task: mesh_train_task(task, device) for task in ("ppo", "gru")})
    launches += sum(r["launches"] for r in ref.values())

    t0 = time.perf_counter()
    two = mesh_lib.launch(mesh_rank, 2, backend="gloo",
                          args=(2, 1, ("env", "budget", "ppo", "gru", "ppo16",
                                       "ppo16_nudged")),
                          store=f"{store_dir}/two")
    two_s = time.perf_counter() - t0
    for task in ("env", "budget"):
        for r, rank in enumerate(two):
            check(same_leaves(rank[task]["state"], ref[task]["state"]),
                  f"mesh two ranks {task}: rank {r}'s assembled state differs from the "
                  f"one-process run")
        print(f"mesh two ranks (gloo on CUDA tensors, dp=2) {task}: assembled state equal to "
              f"the one-process card run; checksum {two[0][task]['checksum']!r} vs "
              f"{ref[task]['checksum']!r}"
              + (f"; budgeted resets {two[0][task]['resets']} vs {ref[task]['resets']}"
                 if task == "budget" else "")
              + f"; crossing_cast launches per rank {[x[task]['launches'] for x in two]}")
    for task in ("ppo", "gru"):
        for r, rank in enumerate(two):
            check_rollout(f"mesh two ranks {task} rank {r}", rank[task], ref[task])
        for k in two[0][task]["local"]:
            check(np.array_equal(two[0][task]["local"][k], two[1][task]["local"][k]),
                  f"mesh two ranks {task}: param {k} differs between the ranks")
        print(f"mesh two ranks {task}: rollout identical to the one-process card run, "
              f"params bit-identical on both ranks, loss {two[0][task]['metrics']['loss']!r}; "
              f"ms per train step {[round(x[task]['step_ms'], 1) for x in two]} (one process "
              f"at {MESH_ENVS} envs: {ref[task]['step_ms']:.1f}); collectives "
              f"per update {two[0][task]['collectives']}, their host ms "
              f"{[round(x[task]['collective_ms'], 2) for x in two]}; crossing_cast launches "
              f"per rank {[x[task]['launches'] for x in two]}")

    t0 = time.perf_counter()
    four = mesh_lib.launch(mesh_rank, 4, backend="gloo", args=(2, 2, ("ppo16",)),
                           store=f"{store_dir}/four")
    four_s = time.perf_counter() - t0
    mp_run, dp_run = four[0]["ppo16"], two[0]["ppo16"]
    check_rollout("mesh four ranks ppo16", mp_run, dp_run)
    grad_err = params_rel_err(mp_run["first_grads"], dp_run["first_grads"])
    loss_err = abs(mp_run["first_loss"] - dp_run["first_loss"]) / abs(dp_run["first_loss"])
    check(grad_err <= 1e-4 and loss_err <= 1e-4,
          f"mesh four ranks: the first minibatch's gradients differ from dp = 2 by "
          f"{grad_err}, its loss by {loss_err}")
    # after the step's 8 Adam updates: recorded, with the same step's
    # response to a one-ulp nudge of trunk.weight as the yardstick
    err = params_rel_err(mp_run["params"], dp_run["params"])
    nudge_err = params_rel_err(two[0]["ppo16_nudged"]["params"], dp_run["params"])
    for k in four[0]["ppo16"]["local"]:
        blocks = {}  # a split param's block per mp index; the others whole
        for x in four:
            key = x["mp_index"] if param_shard_dim(k) is not None else 0
            blocks.setdefault(key, []).append(x["ppo16"]["local"][k])
        check(all(np.array_equal(v, b[0]) for b in blocks.values() for v in b),
              f"mesh four ranks: param {k} differs between ranks that hold the same block")
    print(f"mesh four ranks (gloo, dp=2 x mp=2, rollout cut to {MESH_SHORT_ROLLOUT} steps): "
          f"rollout identical to the dp=2 run from the same state; the first minibatch's "
          f"gradients within {grad_err:.3g} of dp=2's, its loss within {loss_err:.3g}; "
          f"params after the step's {2 * 4} Adam updates within {err:.3g} of dp=2's "
          f"(dp=2 from trunk.weight nudged one ulp: {nudge_err:.3g}); per-param "
          + ", ".join(f"{k} {params_rel_err({k: mp_run['params'][k]}, {k: v}):.3g}"
                      for k, v in dp_run["params"].items())
          + f"; ms per "
          f"train step {[round(x['ppo16']['step_ms'], 1) for x in four]} (dp=2 at this "
          f"rollout {[round(x['ppo16']['step_ms'], 1) for x in two]}); collectives per "
          f"update {four[0]['ppo16']['collectives']}, their host ms "
          f"{[round(x['ppo16']['collective_ms'], 2) for x in four]}; crossing_cast launches "
          f"per rank {[x['ppo16']['launches'] for x in four]}")
    print(f"mesh launches: two ranks {two_s:.1f} s, four ranks {four_s:.1f} s, process "
          f"start included (every rank shares the one card: no scaling figure)")
    for ranks in (two, four):
        launches += sum(x[t]["launches"] for x in ranks for t in x
                        if t not in ("mp_index", "threefry"))
        MAIN_THREEFRY[0] += sum(x["threefry"] for x in ranks)
    shutil.rmtree(store_dir)
    return launches


# ---------------------------------------------------------------------------
# Phase 9: the adapters and tools
# ---------------------------------------------------------------------------

ADAPTER_ENVS = 4096       # flagship_single_room_4096
ADAPTER_STEPS = 64
ADAPTER_CPU_ENVS = 256    # the card's first envs, held against a CPU run of these envs
ADAPTER_CPU_STEPS = 16
GYM_STEPS = 100
WRAPPER_STEPS = 32
VIDEO_STEPS = 32
WEB_KEYS = "wwawdsvrw"
PROFILE_STEP_STEPS = 16
PROFILE_PPO_ENVS = 2048   # ppo_train_step_mlp_bf16


def flagship_cfg(**kw):
    """The JAX bench row flagship_single_room_4096's config: SingleRoom,
    64 rays x 64 px, camera_u32 under ``auto`` (the crossing cast kernel)."""
    import raycastworlds_tpu_torch as rt

    return rt.EnvConfig(num_rays=64, height_camera_view_pu=64, **kw)


def counted(fn):
    """Every count read just before ``fn()`` and just after it, a main-path
    run: (its result, launches by kernel; threefry's go to MAIN_THREEFRY)."""
    import torch

    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launches_since(before, main_run=True)


def expect_crossing(label, launches, want) -> int:
    """``crossing_cast`` must have launched ``want`` times and no other
    kernel at all; returns its launches."""
    expected = {name: (want if name == "crossing_cast" else 0) for name in KERNELS}
    check(launches == expected, f"{label}: kernel launches {launches}, expected {expected}")
    return launches["crossing_cast"]


def profiled_calls(label, fn, name="crossing_cast") -> int:
    """``fn()`` under ``utils/profiling.trace``: the calls of the CUDA
    function ``{name}_kernel`` in its trace (``aggregate_trace``), which
    must be at least one."""
    from raycastworlds_tpu_torch.utils import profiling

    path = os.path.join(TRACE_DIR, "adapters_" + label.replace(" ", "_"))
    with profiling.trace(path):
        fn()
    _, calls, _ = profiling.aggregate_trace(path)
    n = sum(c for k, c in calls.items() if f"{name}_kernel" in k)
    check(n > 0, f"{label}: the profiler saw no {name}_kernel")
    return n


def same_arrays(label, got, want) -> None:
    """Two numpy arrays, equal bit for bit with the same dtype and shape."""
    got, want = np.asarray(got), np.asarray(want)
    check(got.dtype == want.dtype and got.shape == want.shape
          and np.array_equal(got, want, equal_nan=got.dtype.kind == "f"),
          f"{label}: {got.dtype}{got.shape} differs from {want.dtype}{want.shape}")


def same_five_tuple(label, got, want) -> None:
    """(obs, reward, terminated, truncated, info) of two adapter steps."""
    for name, g, w in zip(("obs", "reward", "terminated", "truncated"), got[:4], want[:4]):
        check(type(g) is type(w), f"{label} {name}: {type(g)} vs {type(w)}")
        same_arrays(f"{label} {name}", g, w)
    check(sorted(got[4]) == sorted(want[4]), f"{label}: info keys {sorted(got[4])}")
    for k in want[4]:
        same_arrays(f"{label} info[{k}]", got[4][k], want[4][k])


def first_envs(out, n):
    """A vector adapter step's arrays cut to the first ``n`` envs."""
    obs, reward, term, trunc, info = out
    return (obs[:n], reward[:n], term[:n], trunc[:n], {k: v[:n] for k, v in info.items()})


def vector_adapter_phase(device):
    """9a. GymVectorAdapter at flagship_single_room_4096: ``reset(seed=0)``
    and ADAPTER_STEPS steps of numpy-seeded actions, counted and timed;
    every returned array equal to ``Env.reset``/``Env.step`` on the card
    with the adapter's keys; the first ADAPTER_CPU_ENVS envs of the first
    ADAPTER_CPU_STEPS steps equal to an adapter of that many envs on the
    CPU; again with ``final_observation=True``.  Prints env-steps/s through
    the adapter beside ``Env.step``'s with the obs left on the card
    (``steps_per_second_program``), the host-copy ms per step and the
    crossing cast's launches per step.  Returns (launches, the final state
    of the first run, the first run's launches per step)."""
    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.parallel import rollout
    from raycastworlds_tpu_torch.utils import to_numpy

    cfg = flagship_cfg()
    actions = np.random.default_rng(SEED).integers(
        0, 4, size=(ADAPTER_STEPS, ADAPTER_ENVS)).astype(np.int32)
    total, final_state, rows = 0, None, {}
    for final in (False, True):
        label = "GymVectorAdapter" + (" final_observation" if final else "")
        adapter = rt.GymVectorAdapter(rt.SingleRoom(cfg), ADAPTER_ENVS,
                                      final_observation=final, device=device)

        def drive():
            obs, _ = adapter.reset(seed=SEED)
            t0 = time.perf_counter()
            outs = [adapter.step(a) for a in actions]
            return obs, outs, time.perf_counter() - t0

        (obs0, outs, seconds), launches = counted(drive)
        per_step = 2 if final else 1
        total += expect_crossing(label, launches, 1 + per_step * ADAPTER_STEPS)

        # the same keys through Env on the card, and each step's host copies
        env = rt.Env(rt.SingleRoom(cfg), ADAPTER_ENVS, device=device, final_obs_in_info=final)
        state, obs = env.reset(rt.rng.split(rt.rng.PRNGKey(SEED))[1])
        same_arrays(f"{label} reset obs", obs0, to_numpy(obs))
        ended, copy_ms = 0, []
        for t, (a, got) in enumerate(zip(actions, outs)):
            res = env.step(state, torch.from_numpy(a))
            state = res.state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info = {k: to_numpy(v) for k, v in res.info.items()}
            want = (to_numpy(res.obs), to_numpy(res.reward), info["terminated"],
                    info["truncated"], info)
            copy_ms.append((time.perf_counter() - t0) * 1e3)
            same_five_tuple(f"{label} step {t}", got, want)
            done = got[2] | got[3]
            if final:
                same_arrays(f"{label} step {t} final_observation where no episode ended",
                            got[4]["final_observation"][~done], got[0][~done])
            ended += int(done.sum())
        check(same_state(adapter._state, state), f"{label}: final state differs from Env's")

        cpu = rt.GymVectorAdapter(rt.SingleRoom(cfg), ADAPTER_CPU_ENVS,
                                  final_observation=final, device="cpu")
        same_arrays(f"{label} CPU reset obs", obs0[:ADAPTER_CPU_ENVS], cpu.reset(seed=SEED)[0])
        for t in range(ADAPTER_CPU_STEPS):
            same_five_tuple(f"{label} card vs CPU step {t}",
                            first_envs(outs[t], ADAPTER_CPU_ENVS),
                            cpu.step(actions[t, :ADAPTER_CPU_ENVS]))
        copies = len(outs[0][4]) + 2
        rows[final] = dict(sps=ADAPTER_ENVS * ADAPTER_STEPS / seconds,
                           step_ms=seconds * 1e3 / ADAPTER_STEPS,
                           copy_ms=float(np.median(copy_ms)), copies=copies,
                           per_step=(launches["crossing_cast"] - 1) / ADAPTER_STEPS,
                           ended=ended,
                           calls=profiled_calls(label, lambda: adapter.step(actions[0])))
        if not final:
            final_state = adapter._state
        del outs
        print(f"{label} {ADAPTER_ENVS} envs x {ADAPTER_STEPS} steps (flagship u32 64 x 64, "
              f"auto): every array == Env.reset/Env.step on the card, first "
              f"{ADAPTER_CPU_ENVS} envs x {ADAPTER_CPU_STEPS} steps == a CPU adapter; "
              f"{ended} episode ends; {rows[final]['sps']:.1f} env-steps/s through the "
              f"adapter ({rows[final]['step_ms']:.2f} ms/step); host copy "
              f"{rows[final]['copy_ms']:.2f} ms/step ({copies} arrays); crossing_cast "
              f"{rows[final]['per_step']:.1f} launches/step; the profiler saw "
              f"{rows[final]['calls']} crossing_cast_kernel calls in one step")

    env = rt.Env(rt.SingleRoom(cfg), ADAPTER_ENVS, device=device)
    run = rollout.steps_per_second_program(env, ADAPTER_STEPS)
    state, _ = env.reset(rt.rng.PRNGKey(SEED))
    state, acc = run(state, rt.rng.PRNGKey(SEED + 1))
    float(acc)

    def timed_run():
        t0 = time.perf_counter()
        float(run(state, rt.rng.PRNGKey(SEED + 2))[1])
        return time.perf_counter() - t0

    seconds, launches = counted(timed_run)
    total += expect_crossing("Env.step program", launches, ADAPTER_STEPS)
    sps = ADAPTER_ENVS * ADAPTER_STEPS / seconds
    print(f"flagship Env.step with the obs left on the card (steps_per_second_program): "
          f"{sps:.1f} env-steps/s ({seconds * 1e3 / ADAPTER_STEPS:.2f} ms/step); through "
          f"the vector adapter {rows[False]['sps']:.1f} ({rows[False]['sps'] / sps:.3f}x), "
          f"with final_observation {rows[True]['sps']:.1f}")
    return total, final_state, rows[False]["per_step"]


def gym_adapter_phase(device):
    """9b. GymAdapter at the reference default (512 rays x 256 px, one
    env, max_episode_steps=50): GYM_STEPS steps with a render after each,
    re-seeded on every episode end as tests/test_gym_compat.py does; every
    five-tuple, reset obs and render equal to the same run on the CPU.
    Prints ms per step.  Returns (launches, launches per step after the
    first reset: a step, a render and the re-seeded resets)."""
    import raycastworlds_tpu_torch as rt

    actions = np.random.default_rng(SEED + 1).integers(0, 4, size=GYM_STEPS)

    def drive(dev):
        adapter = rt.GymAdapter(rt.SingleRoom(rt.EnvConfig()), max_episode_steps=50,
                                device=dev)
        out, resets, step_s = [adapter.reset(seed=SEED)[0]], 0, 0.0
        for t, a in enumerate(actions):
            t0 = time.perf_counter()
            step = adapter.step(int(a))
            step_s += time.perf_counter() - t0
            out += [step, adapter.render()]
            if step[2] or step[3]:
                out.append(adapter.reset(seed=t + 1 if step[2] else t + 100)[0])
                resets += 1
        return out, resets, step_s

    (card, resets, step_s), launches = counted(lambda: drive(device))
    n = expect_crossing("GymAdapter", launches, 1 + 2 * GYM_STEPS + resets)
    cpu, cpu_resets, _ = drive("cpu")
    check(len(card) == len(cpu) and resets == cpu_resets, "GymAdapter: runs differ in length")
    for i, (g, w) in enumerate(zip(card, cpu)):
        if isinstance(w, tuple):
            same_five_tuple(f"GymAdapter item {i}", g, w)
        else:
            same_arrays(f"GymAdapter item {i}", g, w)
    check(resets > 0, "GymAdapter: no episode ended")
    print(f"GymAdapter reference default (1 env, 512 rays x 256 px, max_episode_steps 50): "
          f"{GYM_STEPS} steps + renders, {resets} re-seeded resets == the CPU run; "
          f"{step_s * 1e3 / GYM_STEPS:.2f} ms per step; crossing_cast {n} launches")
    return n, (n - 1) / GYM_STEPS


def wrappers_phase(device) -> int:
    """9c. FrameStack(n_stack=4) over the PPO throughput row's env
    (SingleRoom 64 x 64 camera_gray_u8, 4096 envs) and
    ObsTransform(downsample2x) over the flagship u32 env: reset and
    WRAPPER_STEPS steps each, the first ADAPTER_CPU_ENVS envs' obs, reward
    and done equal to a CPU run of those envs."""
    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.utils import to_numpy
    from raycastworlds_tpu_torch.wrappers import downsample2x

    actions = np.random.default_rng(SEED + 2).integers(
        0, 4, size=(WRAPPER_STEPS, ADAPTER_ENVS)).astype(np.int32)
    cases = (
        ("FrameStack(4) camera_gray_u8",
         lambda dev, n: rt.FrameStack(rt.Env(rt.SingleRoom(flagship_cfg(
             obs_type="camera_gray_u8")), n, device=dev), n_stack=4)),
        ("ObsTransform(downsample2x) camera_u32",
         lambda dev, n: rt.ObsTransform(rt.Env(rt.SingleRoom(flagship_cfg()), n, device=dev),
                                        downsample2x)),
    )
    total = 0
    for label, make in cases:
        def drive(dev, n):
            w = make(dev, n)
            state, obs = w.reset(rt.rng.PRNGKey(SEED))
            out = [to_numpy(obs[:ADAPTER_CPU_ENVS])]
            t0 = time.perf_counter()
            for a in actions[:, :n]:
                res = w.step(state, torch.from_numpy(a))
                state = res.state
                out += [to_numpy(x[:ADAPTER_CPU_ENVS]) for x in (res.obs, res.reward, res.done)]
            return w, state, out, time.perf_counter() - t0

        (w, state, card, seconds), launches = counted(lambda: drive(device, ADAPTER_ENVS))
        total += expect_crossing(label, launches, 1 + WRAPPER_STEPS)
        _, _, cpu, _ = drive("cpu", ADAPTER_CPU_ENVS)
        for i, (g, c) in enumerate(zip(card, cpu)):
            same_arrays(f"{label} item {i}", g, c)
        calls = profiled_calls(label, lambda: w.step(state, torch.from_numpy(actions[0])))
        print(f"{label} {ADAPTER_ENVS} envs x {WRAPPER_STEPS} steps: first "
              f"{ADAPTER_CPU_ENVS} envs == the CPU run; {seconds * 1e3 / WRAPPER_STEPS:.2f} "
              f"ms/step (with a {ADAPTER_CPU_ENVS}-env host copy); obs {tuple(card[1].shape)} "
              f"{card[1].dtype} per {ADAPTER_CPU_ENVS} envs; the profiler saw {calls} "
              f"crossing_cast_kernel calls in one step")
    return total


def video_phase(device) -> int:
    """9d. ``record_episode`` on the card (2 envs, VIDEO_STEPS steps) at the
    reference default and at MultiPlayerRoom's main-path config, camera and
    top views: frames equal to the CPU's, and the GIFs written from both
    byte-equal (Pillow where it is installed, else the module's own
    writer; the 256 x 512 views keep every 8th frame, to bound the
    writer's time)."""
    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.utils import video

    cases = (("reference default", rt.SingleRoom, rt.EnvConfig()),
             ("multi_player", rt.MultiPlayerRoom, multi_player_cfg()))
    total = 0
    for label, family, cfg in cases:
        for view in ("camera", "top"):
            name = f"record_episode {label} {view}"

            def record(dev):
                env = rt.Env(family(cfg), num_envs=2, device=dev)
                return video.record_episode(env, rt.rng.PRNGKey(SEED), steps=VIDEO_STEPS,
                                            view=view)

            card, launches = counted(lambda: record(device))
            total += expect_crossing(name, launches, 2 + 2 * VIDEO_STEPS)
            cpu = record("cpu")
            same_arrays(name, card, cpu)
            # one player's frames of MultiPlayerRoom's cameras
            frames = {"card": card, "cpu": cpu}
            if card.ndim == 4:
                frames = {k: v[:, 0] for k, v in frames.items()}
            every = 8 if card.shape[-2] * card.shape[-1] > 64 * 64 else 1
            gifs = []
            for tag, f in frames.items():
                path = os.path.join(TRACE_DIR, f"{name.replace(' ', '_')}_{tag}.gif")
                os.makedirs(TRACE_DIR, exist_ok=True)
                video.save_gif(path, f[::every], fps=8)
                with open(path, "rb") as fh:
                    gifs.append(fh.read())
            check(gifs[0] == gifs[1], f"{name}: GIF bytes differ")
            print(f"{name}: {tuple(card.shape)} frames == the CPU's; GIF of "
                  f"{len(card[::every])} frames byte-equal ({len(gifs[0])} B)")
    return total


def web_phase(device) -> int:
    """9e. WebPlaySession (the viewer's default env, 128 rays x 128 px) on
    the card through the key script WEB_KEYS: every ``frame_png()`` and
    status byte-equal to a CPU session's.  Prints ms per key."""
    from raycastworlds_tpu_torch.utils import webviewer

    def drive(dev):
        session = webviewer.WebPlaySession(seed=SEED, device=dev)
        out, seconds = [session.frame_png(), session.status()], 0.0
        for ch in WEB_KEYS:
            t0 = time.perf_counter()
            out += [session.handle_key(ch), session.frame_png()]
            seconds += time.perf_counter() - t0
        return out, seconds

    (card, seconds), launches = counted(lambda: drive(device))
    # reset and first frame, then a step and a frame per move key, a frame
    # for "v", a reset and a frame for "r"
    moves = sum(ch in "wsad" for ch in WEB_KEYS)
    n = expect_crossing("WebPlaySession", launches,
                        2 + 2 * moves + WEB_KEYS.count("v") + 2 * WEB_KEYS.count("r"))
    cpu, _ = drive("cpu")
    check(card == cpu, "WebPlaySession: card frames or statuses differ from the CPU's")
    print(f"WebPlaySession keys {WEB_KEYS!r}: {len(WEB_KEYS) + 1} PNG frames and statuses "
          f"byte-equal to the CPU session's; {seconds * 1e3 / len(WEB_KEYS):.2f} ms per key "
          f"(step or view change, and the PNG)")
    return n


def debug_phase(device, state) -> int:
    """9f. ``utils/debug``: ``validate_state`` passes on 9a's final state,
    ``checked(env.step)`` returns no error there, and a state with one NaN
    position throws."""
    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.utils import debug

    cfg = flagship_cfg()
    env = rt.Env(rt.SingleRoom(cfg), ADAPTER_ENVS, device=device)
    debug.validate_state(cfg, state)
    actions = torch.zeros(ADAPTER_ENVS, dtype=torch.int32, device=device)
    (err, res), launches = counted(lambda: debug.checked(env.step)(state, actions))
    n = expect_crossing("checked(env.step)", launches, 1)
    check(err.get() is None, f"checked(env.step): {err.get()}")
    pos = res.state.pos_wu.clone()
    pos[7, 0] = float("nan")
    err, _ = debug.checked(lambda s: s.replace(pos_wu=pos))(res.state)
    try:
        err.throw()
        raise AssertionError("no error")
    except RuntimeError as e:
        check("pos_wu: 1 non-finite" in str(e), f"checked NaN state: {e}")
    print("utils/debug: validate_state passes on the vector adapter's final state, "
          "checked(env.step) reports no error, a state with one NaN position throws")
    return n


def profile_step_phase(device) -> int:
    """9g. ``examples/profile_step`` at flagship_single_room_4096 for
    PROFILE_STEP_STEPS steps (its JSON line, top 15 kernels):
    ``crossing_cast_kernel`` in its trace once per step (the profiler may
    drop records)."""
    from raycastworlds_tpu_torch.examples import profile_step
    from raycastworlds_tpu_torch.utils import profiling

    path = os.path.join(TRACE_DIR, "profile_step")
    before = profiling.total("kernel_launches.threefry")
    out, launches = counted(lambda: profile_step.main([
        "--num-envs", str(ADAPTER_ENVS), "--steps", str(PROFILE_STEP_STEPS), "--top", "15",
        "--trace-dir", path, "--device", str(device)]))
    threefry = profiling.total("kernel_launches.threefry") - before
    # the reset's observation, then the warm-up, timed and profiled runs
    n = expect_crossing("profile_step", launches, 1 + 3 * PROFILE_STEP_STEPS)
    _, calls, _ = profiling.aggregate_trace(path)
    seen = sum(c for k, c in calls.items() if "crossing_cast_kernel" in k)
    check(0 < seen <= PROFILE_STEP_STEPS,
          f"profile_step: {seen} crossing_cast_kernel calls in {PROFILE_STEP_STEPS} steps")
    check(out["device"].startswith("cuda") and out["device_ms_per_step"] > 0,
          "profile_step: no device time")
    # the reset's hashes went through the kernel: the env's reset (split, then
    # reset_batch's 8 hashes), then for each of the 3 runs its actions'
    # randint (3 hashes) and 8 a step in the dense reset
    want = 1 + 8 + 3 * (3 + 8 * PROFILE_STEP_STEPS)
    check(threefry == want, f"profile_step: {threefry} threefry launches, expected {want} "
          f"(8 a step)")
    within = {k: v["ms_per_step"] for k, v in out["within"].items()}
    check(0 < within["threefry"] < within["reset_batch"],
          f"profile_step: threefry {within['threefry']} of reset_batch "
          f"{within['reset_batch']} ms per step")
    print(f"profile_step: crossing_cast_kernel {seen} calls in {PROFILE_STEP_STEPS} steps; "
          f"wall {out['wall_ms_per_step']:.2f} ms/step, device "
          f"{out['device_ms_per_step']:.3f} ms/step, busy {out['busy']:.1%}, "
          f"{out['kernels_per_step']:.1f} kernels/step; reset_batch "
          f"{out['within']['reset_batch']['pct']:.1f}%, threefry "
          f"{out['within']['threefry']['pct']:.1f}% of device time; threefry {threefry} "
          f"launches")
    return n


def profile_ppo_phase(device) -> int:
    """9h. ``examples/profile_ppo`` at ppo_train_step_mlp_bf16 (camera_gray,
    2048 envs, mlp hidden 256 bfloat16, 2 epochs), one timed call per phase
    (its JSON line)."""
    from raycastworlds_tpu_torch.examples import profile_ppo

    out, launches = counted(lambda: profile_ppo.main([
        "--num-envs", str(PROFILE_PPO_ENVS), "--rollout-steps", str(STEPS), "--obs", "camera_gray",
        "--hidden", "256", "--dtype", "bfloat16", "--trunk", "mlp", "--epochs", "2",
        "--reps", "1", "--device", str(device)]))
    # init's reset; full and rollout: warm-up + 1, rollout + bootstrap; the
    # captured rollout; env_only: warm-up + 1, no bootstrap; infer_only's obs
    full = STEPS + 2
    n = expect_crossing("profile_ppo", launches, 1 + 2 * full + 2 * full + full
                        + 2 * (STEPS + 1) + 1)
    check(all(v > 0 for v in out["times_ms"].values()), f"profile_ppo: {out['times_ms']}")
    print("profile_ppo ppo_train_step_mlp_bf16 (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["times_ms"].items()))
    return n


def adapter_shape_rows(device, launches=None) -> list:
    """measure() of the crossing cast at phase 9's shapes, on the inputs
    observe_batch hands it after a reset: the vector adapter's flagship
    [4096, 64] and the single-env adapter's reference default [1, 512];
    ``launches``: each one's launches per step, as phases 9a (without
    final_observation) and 9b counted them, by label."""
    import raycastworlds_tpu_torch as rt

    rows = []
    for label, cfg, envs in (
            ("GymVectorAdapter flagship camera_u32", flagship_cfg(), ADAPTER_ENVS),
            ("GymAdapter reference default", rt.EnvConfig(), 1)):
        args, kwargs = observed_inputs("crossing_cast", rt.SingleRoom(cfg), envs, device)
        m = measure("crossing_cast", f"{label}: {cfg.H}x{cfg.W} B={envs} R={cfg.num_rays}",
                    args, kwargs)
        if launches is not None:
            m["launches_per_step"] = launches[label]
        rows.append(m)
    return rows


def adapters_phase(device):
    """Phase 9: the adapters and tools on the card (a-h above), each
    sub-phase's seconds printed.  Returns the crossing cast's launches and,
    for adapter_shape_rows, the adapters' launches per step."""
    t0 = time.perf_counter()
    launches, final_state, vector_per_step = vector_adapter_phase(device)
    seconds = {"a": time.perf_counter() - t0}
    t0 = time.perf_counter()
    n, gym_per_step = gym_adapter_phase(device)
    launches += n
    seconds["b"] = time.perf_counter() - t0
    for tag, fn in (("c", wrappers_phase), ("d", video_phase),
                    ("e", web_phase), ("f", lambda d: debug_phase(d, final_state)),
                    ("g", profile_step_phase), ("h", profile_ppo_phase)):
        t0 = time.perf_counter()
        launches += fn(device)
        seconds[tag] = time.perf_counter() - t0
    print("phase 9 seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; total {sum(seconds.values()):.1f}")
    return launches, {"GymVectorAdapter flagship camera_u32": vector_per_step,
                      "GymAdapter reference default": gym_per_step}


# ---------------------------------------------------------------------------
# Phase 10: the single-env Game API
# ---------------------------------------------------------------------------

SINGLE_STEPS = 64
SINGLE_BATCH = 8          # the batch whose row k a single env's run must be


def single_runs():
    """(label, family, config, kernel backend, kernel, plain backend) of
    every single-env run: each family under ``auto`` (the crossing cast)
    against ``crossing`` and under ``pallas`` (the DDA cast) against
    ``scan``; SingleRoom, DynamicRoom and LockedRoom under ``fused`` (the
    DDA + u32 render kernel) in camera_u32 and camera_gray against ``scan``;
    SingleRoom and RandomRoom in camera_pal8 under ``crossing_kernel_fused``
    (the crossing + pal8 render kernel) against ``crossing``.  SingleRoom at
    the reference default, the other families at the widths of the JAX
    bench rows (bench.py:283-300), MultiPlayerRoom at 2 players."""
    import dataclasses

    import raycastworlds_tpu_torch as rt

    room = dict(height_tile_map_tu=16, width_tile_map_tu=16, num_rays=256,
                height_camera_view_pu=128)
    small = dict(num_rays=64, height_camera_view_pu=64)
    families = {
        "single_room": (rt.SingleRoom, rt.EnvConfig()),
        "random_room": (rt.RandomRoom, rt.RandomRoomConfig(**room)),
        "maze": (rt.Maze, rt.MazeConfig(**small)),
        "multi_goal": (rt.MultiGoalRoom, rt.MultiGoalConfig(**small)),
        "dynamic_room": (rt.DynamicRoom, rt.DynamicRoomConfig(**small)),
        "locked_room": (rt.LockedRoom, rt.LockedRoomConfig(**small)),
        "multi_player 2p": (rt.MultiPlayerRoom, multi_player_cfg()),
    }
    runs = []
    for name, (game, cfg) in families.items():
        runs.append((f"{name} auto", game, cfg, "auto", "crossing_cast", "crossing"))
        runs.append((f"{name} pallas", game, cfg, "pallas", "dda_cast", "scan"))
    for name in ("single_room", "dynamic_room", "locked_room"):
        game, cfg = families[name]
        for obs in ("camera_u32", "camera_gray"):
            runs.append((f"{name} fused {obs}", game, dataclasses.replace(cfg, obs_type=obs),
                         "fused", "dda_render_u32", "scan"))
    for name in ("single_room", "random_room"):
        game, cfg = families[name]
        runs.append((f"{name} crossing_kernel_fused camera_pal8", game,
                     dataclasses.replace(cfg, obs_type="camera_pal8"),
                     "crossing_kernel_fused", "crossing_render_pal8", "crossing"))
    return runs


def facing_goal(state):
    """``state`` (one env or a batch) with the player, player 0 of
    MultiPlayerRoom, 0.2 world units above its goal tile heading +i, so that
    the first forward move scores and ends the episode."""
    import torch

    pos, dir_au = state.pos_wu.clone(), state.dir_au.clone()
    at = state.goal_tu.to(pos.dtype) + torch.tensor([-0.2, 0.5], dtype=pos.dtype,
                                                    device=pos.device)
    if pos.dim() > state.goal_tu.dim():   # a player axis
        pos[..., 0, :], dir_au[..., 0] = at, 0
    else:
        pos[...], dir_au[...] = at, 0
    return state.replace(pos_wu=pos, dir_au=dir_au)


def drive_single(game, key, actions):
    """``reset_single(key)`` on the key's device (the player then placed by
    facing_goal), then per action ``step_single``, a re-reset from
    ``state.rng_key`` where the step ended the episode, and
    ``observe_single``: a single-env caller's loop.  Returns ({leaf: [T+1, ...]} of the states and "obs" of the
    frames, re-resets, ms per step on the host clock, the device
    synchronised at the end)."""
    import torch

    from raycastworlds_tpu_torch.ops import render

    state = facing_goal(game.reset_single(key, key.device))
    states, frames, resets = [state], [game.observe_single(state)], 0
    if state.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in actions:
        state = game.step_single(state, a)
        if bool(state.done):
            state = game.reset_single(state.rng_key, state.device)
            resets += 1
        states.append(state)
        frames.append(game.observe_single(state))
    if state.device.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(actions)
    run = {k: torch.stack([s.leaves()[k] for s in states]) for k in state.leaves()}
    run["obs"] = torch.stack([render.as_i32(f) for f in frames])
    return run, resets, ms


def drive_batch_row(game, keys, actions, k):
    """``reset_batch(keys)`` (every player placed by facing_goal) and
    ``step_batch`` with every env taking the single run's actions, each env
    re-reset from its ``rng_key`` where its episode ended; {leaf: [T+1,
    ...]} of env ``k``'s states."""
    import torch

    from raycastworlds_tpu_torch.state import select

    state = facing_goal(game.reset_batch(keys))
    rows = [state.index(torch.tensor([k], device=keys.device)).unbatch()]
    b = keys.shape[0]
    for a in actions:
        act = torch.as_tensor(a, dtype=torch.int32, device=keys.device)
        state = game.step_batch(state, act.expand((b,) + tuple(act.shape)).contiguous())
        if bool(state.done.any()):
            state = select(state.done, game.reset_batch(state.rng_key), state)
        rows.append(state.index(torch.tensor([k], device=keys.device)).unbatch())
    return {leaf: torch.stack([r.leaves()[leaf] for r in rows]) for leaf in rows[0].leaves()}


def same_run(label, got, want) -> None:
    """Every stack of ``want`` equal to ``got``'s, bit for bit with the same
    dtypes (``got`` may hold more, as a single run's frames)."""
    import torch

    check(set(want) <= set(got), f"{label}: leaves {sorted(got)} lack {sorted(want)}")
    for k in sorted(want):
        g, w = got[k], want[k].to(got[k].device)
        check(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w),
              f"{label}: {k} differs ({g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)})")


def profiled_single(label, game, key, actions, kernel, want) -> None:
    """The kernel run again under torch.profiler (CUDA activity only: the
    CPU operators' records would cost seconds a run): the trace must hold
    exactly ``want`` calls of ``{kernel}_kernel`` and none of the other
    three kernels.  The profiler can drop a record from a window (a run
    has shown 64 of 65 launches that the counts saw), so a run that shows
    fewer calls and no other kernel is repeated, twice at most, and each
    repeat is printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raycastworlds_tpu_torch.utils import profiling

    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, "single_" + label.replace(" ", "_") + ".json")
    expected = {name: (want if name == kernel else 0) for name in KERNELS}
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            drive_single(game, key, actions)
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        _, calls, _ = profiling.aggregate_trace(path)
        seen = {name: sum(c for n, c in calls.items() if f"{name}_kernel" in n)
                for name in KERNELS}
        check(all(seen[n] <= expected[n] for n in KERNELS),
              f"{label}: the profiler saw {seen}, expected {expected}")
        if seen == expected:
            return
        print(f"{label}: profile {attempt + 1} dropped records: saw {seen}, "
              f"expected {expected}")
    raise RuntimeError(f"chip_smoke check failed: {label}: the profiler saw {seen} "
                       f"in 3 runs, expected {expected}")


def single_run_phase(i, label, game_cls, cfg, kernel_backend, kernel, plain, device) -> dict:
    """10a. One single-env run on the card (see drive_single), counted
    (``kernel`` once per observation, no other kernel) and profiled, against
    the plain backend on the card, the same run on the CPU, and row k of an
    8-env batch run on the card with the same keys and actions.  Returns
    the launches, by kernel, and the card's and CPU's ms per step."""
    import dataclasses

    import raycastworlds_tpu_torch as rt

    kcfg = dataclasses.replace(cfg, raycast_backend=kernel_backend)
    game = game_cls(kcfg)
    shape = game.action_shape
    actions = np.random.default_rng(SEED + 100 + i).choice(
        4, size=(SINGLE_STEPS,) + shape, p=[0.55, 0.05, 0.2, 0.2]).astype(np.int32)
    actions[:3] = 0                       # into the goal: a re-reset
    actions = [a if shape else int(a) for a in actions]
    k = i % SINGLE_BATCH
    keys = rt.rng.split(rt.rng.PRNGKey(SEED + i, device), SINGLE_BATCH)
    (run, resets, ms), launches = counted(lambda: drive_single(game, keys[k], actions))
    observations = SINGLE_STEPS + 1
    want = {name: (observations if name == kernel else 0) for name in KERNELS}
    check(launches == want, f"{label}: kernel launches {launches}, expected {want}")
    check(tuple(run["obs"].shape[1:]) == cfg.obs_shape,
          f"{label}: obs shape {tuple(run['obs'].shape[1:])}")
    t0 = time.perf_counter()
    profiled_single(label, game, keys[k], actions, kernel, observations)
    t_prof = time.perf_counter() - t0
    plain_run, plain_resets, plain_ms = drive_single(
        game_cls(dataclasses.replace(cfg, raycast_backend=plain)), keys[k], actions)
    same_run(f"{label}: {plain} on the card", plain_run, run)
    cpu_run, cpu_resets, cpu_ms = drive_single(game_cls(kcfg), keys[k].cpu(), actions)
    same_run(f"{label}: the CPU run", cpu_run, run)
    t0 = time.perf_counter()
    row = drive_batch_row(game, keys, actions, k)
    t_batch = time.perf_counter() - t0
    same_run(f"{label}: row {k} of the {SINGLE_BATCH}-env batch", run, row)
    check(resets == plain_resets == cpu_resets, f"{label}: re-resets differ")
    print(f"single {label}: reset + {SINGLE_STEPS} steps, {resets} re-resets, obs "
          f"{cfg.obs_shape}; {kernel} {launches[kernel]} launches (profiled: the same), == "
          f"{plain} on the card == the CPU run == row {k} of {SINGLE_BATCH} envs; ms per "
          f"step: card {ms:.3f} ({plain} {plain_ms:.3f}), CPU {cpu_ms:.3f}; profiled run "
          f"{t_prof:.1f} s, batch run {t_batch:.1f} s")
    return dict(launches=launches, resets=resets, ms=ms, plain_ms=plain_ms, cpu_ms=cpu_ms)


def pallas_single_phase(device, num=16) -> int:
    """10b. ``raycast_pallas.cast_rays_pallas`` (one env, the DDA kernel at
    [1, 512]) equal to ``cast_rays_scan`` on the card at the reference
    default, over ``num`` reset states; returns its launches."""
    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.ops import raycast, raycast_pallas

    cfg = rt.EnvConfig(raycast_backend="pallas")
    game = rt.SingleRoom(cfg)
    states = game.reset_batch(rt.rng.split(rt.rng.PRNGKey(SEED + 7, device), num))
    _, words = game._packed_maps_batch(states)
    total = 0
    for q in range(num):
        s = states.index(torch.tensor([q], device=device)).unbatch()
        hits, launches = counted(lambda: raycast_pallas.cast_rays_pallas(
            cfg, words[q], s.pos_wu, s.dir_au))
        check(launches["dda_cast"] == 1 and sum(launches.values()) == 1,
              f"cast_rays_pallas: launches {launches}")
        total += 1
        want = raycast.cast_rays_scan(words[q][None], (cfg.H, cfg.W), s.pos_wu[None],
                                      hits.ray_dirs[None], cfg.dda_steps)
        for name, g, w in zip(("hit_tu", "hit_dim", "dist_wu"), hits[1:], want):
            check(g.shape == w.shape[1:] and torch.equal(g, w[0]),
                  f"cast_rays_pallas: {name} differs from cast_rays_scan")
    print(f"cast_rays_pallas == cast_rays_scan at [1, {cfg.num_rays}] on {num} reset states "
          f"(one dda_cast launch each)")
    return total


def single_paths():
    """The SingleRoom runs of single_runs(), one per kernel, as main_paths()
    tuples of one env: the B=1 shapes that shape_rows measures."""
    return [(label, game, cfg, 1, backend, kernel, [plain], {})
            for label, game, cfg, backend, kernel, plain in single_runs()
            if label.startswith("single_room") and "gray" not in label]


def single_phase(device):
    """Phase 10: every single-env run (10a), cast_rays_pallas (10b).
    Returns the launches, by kernel, and the launches per single step of
    each SingleRoom run at the reference default, by label."""
    t0 = time.perf_counter()
    launches = {name: 0 for name in KERNELS}
    per_step, summary = {}, []
    resets = 0
    for i, (label, game, cfg, backend, kernel, plain) in enumerate(single_runs()):
        out = single_run_phase(i, label, game, cfg, backend, kernel, plain, device)
        for name, n in out["launches"].items():
            launches[name] += n
        resets += out["resets"]
        if label.startswith("single_room"):
            per_step[label] = out["launches"][kernel] / (SINGLE_STEPS + 1)
            summary.append(f"{label} card {out['ms']:.3f} / CPU {out['cpu_ms']:.3f}")
    check(resets > 0, "single-env runs: no episode ended, no re-reset was driven")
    launches["dda_cast"] += pallas_single_phase(device)
    print("single-env ms per step (reset_single excluded), SingleRoom reference default: "
          + "; ".join(summary))
    print(f"phase 10: {resets} re-resets in all, {time.perf_counter() - t0:.1f} s")
    return launches, per_step


# ---------------------------------------------------------------------------
# Phase 11: the port bench
# ---------------------------------------------------------------------------

# the bench's rows cut to this many steps and one timed rep (the warm-up
# and the rep: 2 runs)
BENCH_STEPS = 8
# backend -> the kernel it launches once per observation
BACKEND_KERNELS = {
    "crossing_kernel": "crossing_cast",
    "crossing_kernel_fused": "crossing_render_pal8",
    "pallas": "dda_cast",
    "fused": "dda_render_u32",
}
# bench_ppo's variants, cut to 16 rollout steps and one timed update
BENCH_PPO_VARIANTS = [
    [],
    ["--trunk", "mlp", "--dtype", "bfloat16", "--phases"],
    ["--recurrent", "--game", "maze"],
    ["--game", "multi_player"],
    ["--mesh"],
]


def bench_run(kw, device, raycast=None):
    """``bench.run_one`` of a ``SUITE`` row's kwargs ``kw`` at BENCH_STEPS
    steps and one rep (under ``raycast`` where given), counted: (its row,
    its final env state, launches by kernel).  The final state is caught
    by wrapping the bench's ``steps_per_second_program`` for the call."""
    from raycastworlds_tpu_torch import bench

    kw = dict(kw, steps=BENCH_STEPS, reps=1)
    if raycast is not None:
        kw["raycast"] = raycast
    program = bench.steps_per_second_program
    final = {}

    def catching(env, steps):
        run = program(env, steps)

        def wrapped(state, key):
            state, acc = run(state, key)
            final["state"] = state
            return state, acc

        return wrapped

    bench.steps_per_second_program = catching
    try:
        row, launches = counted(lambda: bench.run_one(**kw, device=device))
    finally:
        bench.steps_per_second_program = program
    return row, final["state"], launches


def bench_rows_phase(device) -> dict:
    """11a-b: every ``SUITE`` row through ``bench.run_one`` at its own
    widths, then the CLI's ``--raycast pallas`` and ``fused`` at the
    flagship and reference-default widths.  Each run: ``auto`` resolved to
    ``crossing_kernel`` (the row's named backend otherwise), its kernel
    launched once per observation made (the reset's, then one per step of
    the warm-up and the rep; one launch for both players of
    MultiPlayerRoom) and no other kernel, a positive rate and a finite
    checksum; then the same row under its plain backend (``crossing``;
    ``scan`` for the DDA kernels) from the same keys, launching no kernel:
    checksum and final state identical bit for bit.  Returns the kernel
    runs' launches, by kernel."""
    from raycastworlds_tpu_torch import bench

    suite = dict(bench.SUITE)
    cases = [(name, kw, None) for name, kw in bench.SUITE] + [
        (name, suite[name], raycast)
        for name in ("flagship_single_room_4096", "ref_default_res_512x256")
        for raycast in ("pallas", "fused")]
    observations = 1 + 2 * BENCH_STEPS
    launches = {name: 0 for name in KERNELS}
    for name, kw, raycast in cases:
        row, state, n = bench_run(kw, device, raycast)
        named = raycast or kw.get("raycast", "auto")
        backend = row["config"]["resolved_backend"]
        check(backend == ("crossing_kernel" if named == "auto" else named),
              f"bench {name}: {named} resolved to {backend}")
        kernel = BACKEND_KERNELS[backend]
        want = {k: (observations if k == kernel else 0) for k in KERNELS}
        check(n == want, f"bench {name} [{backend}]: kernel launches {n} for "
                         f"{observations} observations, expected {want}")
        check(row["value"] > 0 and math.isfinite(row["checksum"]),
              f"bench {name} [{backend}]: value {row['value']}, checksum {row['checksum']}")
        plain = "scan" if kernel.startswith("dda") else "crossing"
        p_row, p_state, p_n = bench_run(kw, device, plain)
        check(not any(p_n.values()), f"bench {name} [{plain}]: kernel launches {p_n}")
        check(p_row["checksum"] == row["checksum"] and same_state(p_state, state),
              f"bench {name}: {backend} and {plain} differ (checksums "
              f"{row['checksum']!r}, {p_row['checksum']!r})")
        launches[kernel] += n[kernel]
        print(f"bench {name} [{backend}]: {kernel} launches {n[kernel]} "
              f"({observations} observations), no other kernel; checksum "
              f"{row['checksum']!r} == {plain}'s, final states equal; "
              f"{row['value']} env-steps/s ({plain} {p_row['value']}) at "
              f"{BENCH_STEPS} steps, roofline {row['roofline']['binding']} "
              f"{row['roofline']['frac_of_roofline']}")
    return launches


def bench_ppo_rows_phase(device) -> int:
    """11c: ``bench.run_ppo_row`` for each of ``PPO_ROWS`` at full width,
    counted: ``crossing_cast`` once per observation (the reset's, then one
    warm-up and 6 timed updates) and no other kernel, every update's loss
    finite; then ``bench.run_suite`` over two env rows (cut to BENCH_STEPS
    steps, one rep) and the first PPO row: one JSON line, ``summary`` its
    last key, no row with ``error``, the same launches.  Returns the
    crossing cast's launches."""
    import contextlib
    import io

    from raycastworlds_tpu_torch import bench
    from raycastworlds_tpu_torch.parallel.ppo import PPOTrainer
    from raycastworlds_tpu_torch.parallel.ppo_rnn import RecurrentPPOTrainer

    losses = []
    steps = {cls: cls.train_step for cls in (PPOTrainer, RecurrentPPOTrainer)}

    def recording(train_step):
        def wrapped(self, ts):
            ts, metrics = train_step(self, ts)
            losses.append(metrics["loss"])
            return ts, metrics
        return wrapped

    def per_row(kw):
        return 64 + (1 if kw.get("recurrent") else 2)

    total = 0
    for cls, fn in steps.items():
        cls.train_step = recording(fn)
    try:
        for kw in bench.PPO_ROWS:
            losses.clear()
            row, n = counted(lambda: bench.run_ppo_row(**kw, device=device))
            updates = 7
            total += expect_crossing(kw["name"], n, 1 + updates * per_row(kw))
            loss = [float(x) for x in losses]
            check(len(loss) == updates and all(math.isfinite(x) for x in loss),
                  f"bench {kw['name']}: losses {loss}")
            check(row["value"] > 0, f"bench {kw['name']}: value {row['value']}")
            print(f"bench {kw['name']}: {row['value']} env-steps/s through the train step "
                  f"({row['seconds']} s for 6 updates), crossing_cast launches "
                  f"{n['crossing_cast']} (1 + {updates} x {per_row(kw)}), no other kernel; "
                  f"last loss {loss[-1]!r}")
    finally:
        for cls, fn in steps.items():
            cls.train_step = fn

    rows = [(name, dict(kw, steps=BENCH_STEPS, reps=1)) for name, kw in bench.SUITE[:2]]
    ppo = bench.PPO_ROWS[:1]
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        result, n = counted(lambda: bench.run_suite(rows, ppo, device=device))
    lines = stdout.getvalue().strip().splitlines()
    check(len(lines) == 1 and json.loads(lines[0]) == result,
          f"run_suite printed {len(lines)} lines")
    check(list(result)[-1] == "summary", f"run_suite keys {list(result)}")
    check(not any("error" in row for row in result["rows"]),
          f"run_suite errors: {[r for r in result['rows'] if 'error' in r]}")
    want = len(rows) * (1 + 2 * BENCH_STEPS) + 1 + 7 * per_row(ppo[0])
    total += expect_crossing("run_suite", n, want)
    print(f"bench run_suite ({len(rows)} rows, 1 PPO row): one JSON line, summary last "
          f"{json.dumps(result['summary'])}; crossing_cast launches {n['crossing_cast']}")
    return total


def bench_ppo_cli_phase() -> None:
    """11d: ``python -m raycastworlds_tpu_torch.bench_ppo`` once per
    variant of BENCH_PPO_VARIANTS (its default widths, 16 rollout steps, one
    timed update; ``--mesh`` at one rank): each prints its JSON line, on
    the card, with the variant's config."""
    for args in BENCH_PPO_VARIANTS:
        argv = args + ["--rollout-steps", "16", "--updates", "1"]
        out = subprocess.run(
            [sys.executable, "-m", "raycastworlds_tpu_torch.bench_ppo", *argv],
            capture_output=True, text=True, timeout=300, cwd=ROOT)
        check(out.returncode == 0, f"bench_ppo {argv}: {out.stderr[-2000:]}")
        lines = out.stdout.strip().splitlines()
        check(len(lines) == 1, f"bench_ppo {argv}: {len(lines)} lines")
        row = json.loads(lines[0])
        cfg = row["config"]
        check(row["value"] > 0 and cfg["n_devices"] == 1 and cfg["device"] != "cpu"
              and cfg["recurrent"] == ("--recurrent" in args)
              and ("phases" in row) == ("--phases" in args),
              f"bench_ppo {argv}: {lines[0]}")
        print(f"bench_ppo {' '.join(argv)}: {lines[0]}")


def bench_phase(device) -> dict:
    """Phase 11: the port bench (11a-d), each sub-phase's seconds printed.
    Returns the launches, by kernel."""
    seconds = {}
    t0 = time.perf_counter()
    launches = bench_rows_phase(device)
    seconds["ab"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["crossing_cast"] += bench_ppo_rows_phase(device)
    seconds["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bench_ppo_cli_phase()
    seconds["d"] = time.perf_counter() - t0
    print("phase 11 seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; total {sum(seconds.values()):.1f}")
    return launches


def finish(smi, record=None) -> None:
    """The last lines: the card's name and power limit (``smi``) again, so
    that they stand beside the numbers, ``record``'s JSON, and the ok line."""
    import torch

    print(smi)
    if record is not None:
        print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    times_only = sys.argv[1:] == ["--times-only"]
    mesh_only = sys.argv[1:] == ["--mesh-only"]
    adapters_only = sys.argv[1:] == ["--adapters-only"]
    single_only = sys.argv[1:] == ["--single-only"]
    bench_only = sys.argv[1:] == ["--bench-only"]
    flood_only = sys.argv[1:] == ["--flood-only"]
    check(times_only or mesh_only or adapters_only or single_only or bench_only
          or flood_only or not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")
    sys.path.insert(0, ROOT)
    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch import cuda_build
    from raycastworlds_tpu_torch.ops import raycast

    device = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    cuda_build.load()
    lib = cuda_build.library_path()
    print(f"build and load: {time.perf_counter() - t0:.2f} s -> {lib}")
    with open(lib + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {line.strip()}")

    if mesh_only:
        print(json.dumps({"mesh_launches": {"crossing_cast": mesh_phase(device)}}))
        from raycastworlds_tpu_torch import bench_scaling

        bench_scaling.main(["--steps", str(STEPS)])
        finish(smi)
        return

    if adapters_only:
        launches, per_step = adapters_phase(device)
        finish(smi, {"adapter_launches": {"crossing_cast": launches},
                     "times": adapter_shape_rows(device, per_step)})
        return

    if single_only:
        launches, per_step = single_phase(device)
        finish(smi, {"single_launches": launches,
                     "times": shape_rows(device, single_paths(), per_step)})
        return

    if bench_only:
        finish(smi, {"bench_launches": bench_phase(device)})
        return

    if flood_only:
        finish(smi, {"kernels": [flood_record(flood_rows(device))]})
        return

    paths = main_paths()
    if times_only:
        ref = reference_rows(device)
        rows = (threefry_rows(device) + flood_rows(device) + shape_rows(device, paths)
                + trainer_shape_rows(device)
                + adapter_shape_rows(device) + shape_rows(device, single_paths()))
        finish(smi, {"times": list(ref.values()) + rows})
        return

    # 3. every kernel against its plain version on the card (exact), and
    # its times and bound at the reference-default shape
    errs = kernel_phase(device)
    ref = reference_rows(device)
    threefry = threefry_rows(device)
    fills = flood_rows(device)
    words, pos, dirs = fuzz_inputs(8, 16, 4096, 512, SEED, device)
    plain_crossing = time_ms(lambda: raycast.cast_rays_crossing(words, (8, 16), pos, dirs), 3)
    print(f"plain crossing cast at B=4096 R=512 8x16: {plain_crossing:.4f} ms")
    del words, pos, dirs

    # 4. golden frames through the crossing kernel; top views card == CPU
    golden_phase(device)
    top_view_phase(device)
    pal8_decode_phase(device)

    # 5. the main paths
    check(rt.EnvConfig().resolved_raycast_backend(device.type) == "crossing_kernel",
          "auto does not resolve to the crossing kernel on this device")
    launches = {name: 0 for name in KERNELS}
    per_step = {}
    for label, game, cfg, num_envs, backend, kernel, plains_, kw in paths:
        run = main_path_phase(label, game, cfg, num_envs, device, backend, kernel,
                              plains_, **kw)
        for name, n in run.items():
            launches[name] += n
        if kernel is not None:
            per_step[label] = run[kernel] / (STEPS + 1)

    plain_path_phase("continuous heading camera_u32",
                     rt.EnvConfig(continuous_heading=True, turn_increment_au=0.7), device)
    plain_path_phase("float64 camera_u32", rt.EnvConfig(dtype="float64"), device)
    large_map_phase(device)

    profile_step("multi_player camera_u32", rt.MultiPlayerRoom, multi_player_cfg(), 4096,
                 device)
    profile_step("checker camera_u32", rt.SingleRoom, rt.EnvConfig(wall_texture="checker"),
                 4096, device)

    # 6. each kernel at every main-path shape, on the path's own inputs
    # (the trainers' and adapters' shapes after phases 7 and 9, which count
    # their launches)
    rows = shape_rows(device, paths, per_step)

    # 7. the PPO rows: the trainers through the crossing cast kernel.  A
    # float32 product runs in full float32 (cuBLAS and cuDNN without TF32),
    # so that the kernel and plain train steps compare at float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ppo_per_step = {}
    for row in PPO_ROWS:
        out = ppo_row_phase(row, device)
        launches["crossing_cast"] += out["launches"]
        ppo_per_step[row] = out["per_step"]
    rows += trainer_shape_rows(device, ppo_per_step)
    ppo_kernel_vs_plain(device)
    ppo_layers(device)
    ppo_profile(device)

    # 8. the mesh: one rank under NCCL, two and four ranks on the one card
    # under gloo, then bench_scaling at one rank (its JSON line)
    launches["crossing_cast"] += mesh_phase(device)
    from raycastworlds_tpu_torch import bench_scaling

    bench_scaling.main(["--steps", str(STEPS)])

    # 9. the adapters and tools
    n, adapter_per_step = adapters_phase(device)
    launches["crossing_cast"] += n
    rows += adapter_shape_rows(device, adapter_per_step)

    # 10. the single-env Game API: every kernel at one env
    single_launches, single_per_step = single_phase(device)
    for name, n in single_launches.items():
        launches[name] += n
    rows += shape_rows(device, single_paths(), single_per_step)

    # 11. the port bench: every row through each kernel, == the plain
    # backends, the PPO rows, run_suite, bench_ppo's variants
    for name, n in bench_phase(device).items():
        launches[name] += n

    finish(smi, {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(errs[name] + [r["max_abs_err"] for r in rows
                                             if r["kernel"] == name]),
            "ms": ref[name]["ms"],
            "plain_ms": ref[name]["plain_ms"],
            "device_ms": ref[name]["device_ms"],
            "bound_ms": ref[name]["bound_ms"],
            "bound_by": ref[name]["bound_by"],
            "bound_share": ref[name]["bound_share"],
            "library_ms": None,
            "shapes": [{k: r[k] for k in ("shape", "launches_per_step", "device_ms", "ms",
                                          "plain_ms", "bound_ms", "bound_share")}
                       for r in rows if r["kernel"] == name],
        }
        for name, (source, replaces) in KERNELS.items()
    ] + [threefry_record(threefry), flood_record(fills)]})


if __name__ == "__main__":
    main()
