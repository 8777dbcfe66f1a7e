#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``raycastworlds_tpu_torch/csrc`` and drives the
port's main paths, ``Env(Family(Config(raycast_backend=B)))`` with dense or
budgeted auto-reset, on the card.  Phases, each printing a line:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. the kernel build and its seconds;
3. each kernel against its plain PyTorch version on the card, exact on
   every output: at the reference-default shape (4096 envs x 512 rays x 256
   px, 8x16 map), at maps 13x9, 24x40 and 48x48, and on sliding inputs
   (integer positions and axis-parallel rays); the DDA kernels also with
   a truncated march, the fused u32 render with and without block words;
   plus each kernel's time and its plain version's;
4. the golden frame of tests/data/golden_frames.npz ("single_room", pinned
   from the JAX package) reproduced through the crossing kernel;
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
     checksums within 1e-6 relative, reset frames 99.9% equal.
   Each budgeted phase prints how many envs its budget reset.

The line before the last is the kernels' JSON record, each kernel's
launches summed over the main paths that route through it; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises: there is no
fallback, and a machine without a CUDA device, or a directory without the
package, exits non-zero before printing a result.
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


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def wrappers():
    """name -> the kernel's wrapper (which carries ``.launches``)."""
    from raycastworlds_tpu_torch.ops import raycast_crossing_kernel as rck
    from raycastworlds_tpu_torch.ops import raycast_pallas, render_fused

    return {
        "crossing_cast": rck.cast_rays_crossing_kernel,
        "crossing_render_pal8": rck.cast_render_pal8_kernel,
        "dda_cast": raycast_pallas.cast_rays_pallas_batched,
        "dda_render_u32": render_fused.render_camera_fused_batched,
    }


def random_maps(rng, b, h, w, density):
    maps = rng.random((b, h, w)) < density
    maps[:, 0, :] = maps[:, -1, :] = True
    maps[:, :, 0] = maps[:, :, -1] = True
    return maps


def fuzz_inputs(h, w, b, r, seed, device, sliding=False):
    """Packed random maps (border walls, interior walls at density 0.25),
    random interior positions and random unit directions, from
    numpy.random.default_rng(seed).  ``sliding``: integer positions and
    axis-parallel rays (an exact-zero component) for every ray."""
    import torch

    from raycastworlds_tpu_torch.ops.bitmap import pack_bits_np

    rng = np.random.default_rng(seed)
    words = pack_bits_np(random_maps(rng, b, h, w, 0.25)).view(np.int32)
    if sliding:
        pos = rng.integers(1, [h - 1, w - 1], size=(b, 2)).astype(np.float32)
        axis = np.array([[1, 0], [-1, 0], [0, 1], [0, -1]], np.float32)
        dirs = axis[rng.integers(0, 4, size=(b, r))]
    else:
        pos = rng.uniform([1.0, 1.0], [h - 1.0, w - 1.0], size=(b, 2)).astype(np.float32)
        ang = rng.uniform(0.0, 2.0 * np.pi, size=(b, r))
        dirs = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return t(words), t(pos), t(dirs)


def render_inputs(h, w, b, r, hpu, seed, device, sliding=False):
    """Inputs of the fused render kernels as a SingleRoom-like world gives
    them: random walls (density 0.25) inside a border, block tiles on 15%
    of the other tiles, a goal tile on an empty interior tile (obstacles =
    walls | blocks | goal), random interior positions and headings, each
    heading's player direction and mirror-ordered ray fan (R rays, 128
    headings), and the render constants.  ``sliding``: integer positions, axis headings with
    exact axis player directions, and the first 8 rays of every fan along
    the heading (an exact-zero component)."""
    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.ops import render
    from raycastworlds_tpu_torch.ops.bitmap import pack_bits_np

    cfg = rt.EnvConfig(height_tile_map_tu=h, width_tile_map_tu=w, num_rays=r,
                       height_camera_view_pu=hpu)
    rng = np.random.default_rng(seed)
    walls = random_maps(rng, b, h, w, 0.25)
    goal = rng.integers(1, [h - 1, w - 1], size=(b, 2)).astype(np.int32)
    walls[np.arange(b), goal[:, 0], goal[:, 1]] = False
    blocks = (rng.random((b, h, w)) < 0.15) & ~walls
    blocks[np.arange(b), goal[:, 0], goal[:, 1]] = False
    obst = walls | blocks
    obst[np.arange(b), goal[:, 0], goal[:, 1]] = True
    if sliding:
        pos = rng.integers(1, [h - 1, w - 1], size=(b, 2)).astype(np.float32)
        q = rng.integers(0, 4, size=b)
        dir_au = q * (cfg.num_directions // 4)
        pdir = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], np.float32)[q]
        dirs = cfg.ray_fan_lut_flipped[dir_au].copy()
        dirs[:, :8] = pdir[:, None, :]
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


def compare_crossing(h, w, b, r, seed, device, sliding=False) -> float:
    from raycastworlds_tpu_torch.ops import raycast_crossing_kernel as rck

    words, pos, dirs = fuzz_inputs(h, w, b, r, seed, device, sliding)
    return kernel_vs_plain(
        "crossing_cast", f"{h}x{w} B={b} R={r} sliding={sliding}",
        lambda: rck.cast_rays_crossing_kernel(words, (h, w), pos, dirs),
        lambda: rck.cast_rays_crossing_kernel_ref(words, (h, w), pos, dirs),
    )


def compare_dda(h, w, b, r, seed, device, sliding=False, max_steps=None) -> float:
    from raycastworlds_tpu_torch.ops import raycast, raycast_pallas

    words, pos, dirs = fuzz_inputs(h, w, b, r, seed, device, sliding)
    steps = h + w if max_steps is None else max_steps
    return kernel_vs_plain(
        "dda_cast", f"{h}x{w} B={b} R={r} sliding={sliding} steps={steps}",
        lambda: raycast_pallas.cast_rays_pallas_batched(words, (h, w), pos, dirs, steps),
        lambda: raycast.cast_rays_scan(words, (h, w), pos, dirs, steps),
    )


def compare_pal8(h, w, b, r, hpu, seed, device, sliding=False) -> float:
    from raycastworlds_tpu_torch.ops import raycast_crossing_kernel as rck

    x = render_inputs(h, w, b, r, hpu, seed, device, sliding)
    args = (x["obstacle_words"], x["shape"], x["pos"], x["dirs"], x["pdir"],
            x["goal"], hpu, x["num"], x["denom"])
    return kernel_vs_plain(
        "crossing_render_pal8", f"{h}x{w} B={b} R={r} hpu={hpu} sliding={sliding}",
        lambda: rck.cast_render_pal8_kernel(*args),
        lambda: rck.cast_render_pal8_kernel_ref(*args),
    )


def compare_fused(h, w, b, r, hpu, seed, device, sliding=False, max_steps=None,
                  blocks=False) -> float:
    from raycastworlds_tpu_torch.ops import render_fused

    x = render_inputs(h, w, b, r, hpu, seed, device, sliding)
    steps = h + w if max_steps is None else max_steps
    args = (x["obstacle_words"], x["wall_words"], x["shape"], x["pos"], x["pdir"],
            x["dirs"], steps, hpu, x["num"], x["denom"],
            x["block_words"] if blocks else None)
    return kernel_vs_plain(
        "dda_render_u32",
        f"{h}x{w} B={b} R={r} hpu={hpu} sliding={sliding} steps={steps} blocks={blocks}",
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


def kernel_phase(device):
    """Every kernel against its plain version on every input set, then the
    times at the reference-default shape.  Returns {name: (max err, kernel
    ms, plain ms)}."""
    from raycastworlds_tpu_torch.ops import raycast, raycast_pallas, render_fused
    from raycastworlds_tpu_torch.ops import raycast_crossing_kernel as rck

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
        errs["crossing_cast"].append(compare_crossing(h, w, 256, r, seed, device, sliding=True))
        errs["dda_cast"].append(compare_dda(h, w, 256, r, seed, device, sliding=True))
    for (h, w, r, hpu), seed in (((8, 16, 513, 256), SEED + 3), ((24, 40, 333, 100), SEED + 4)):
        errs["crossing_render_pal8"].append(
            compare_pal8(h, w, 256, r, hpu, seed, device, sliding=True))
        errs["dda_render_u32"].append(
            compare_fused(h, w, 256, r, hpu, seed, device, sliding=True, blocks=True))
    errs["dda_cast"].append(compare_dda(8, 16, 512, 512, SEED + 5, device, max_steps=3))
    errs["dda_cast"].append(compare_dda(24, 40, 256, 333, SEED + 6, device, sliding=True,
                                        max_steps=3))
    for blocks in (False, True):
        errs["dda_render_u32"].append(compare_fused(8, 16, 512, 512, 256, SEED + 7, device,
                                                    max_steps=3, blocks=blocks))

    words, pos, dirs = fuzz_inputs(8, 16, 4096, 512, SEED, device)
    x = render_inputs(8, 16, 4096, 512, 256, SEED, device)
    pal8_args = (x["obstacle_words"], x["shape"], x["pos"], x["dirs"], x["pdir"],
                 x["goal"], 256, x["num"], x["denom"])
    fused_args = (x["obstacle_words"], x["wall_words"], x["shape"], x["pos"],
                  x["pdir"], x["dirs"], 24, 256, x["num"], x["denom"])
    calls = {
        "crossing_cast": (
            lambda: rck.cast_rays_crossing_kernel(words, (8, 16), pos, dirs),
            lambda: rck.cast_rays_crossing_kernel_ref(words, (8, 16), pos, dirs)),
        "dda_cast": (
            lambda: raycast_pallas.cast_rays_pallas_batched(words, (8, 16), pos, dirs, 24),
            lambda: raycast.cast_rays_scan(words, (8, 16), pos, dirs, 24)),
        "crossing_render_pal8": (
            lambda: rck.cast_render_pal8_kernel(*pal8_args),
            lambda: rck.cast_render_pal8_kernel_ref(*pal8_args)),
        "dda_render_u32": (
            lambda: render_fused.render_camera_fused_batched(*fused_args),
            lambda: render_fused.render_camera_fused_batched_ref(*fused_args)),
    }
    out = {}
    for name, (kernel, plain) in calls.items():
        k_ms = time_ms(kernel, 20)
        p_ms = time_ms(plain, 3)
        out[name] = (max(errs[name]), k_ms, p_ms)
        print(f"{name}: kernel == plain on {len(errs[name])} input sets (max abs err "
              f"{out[name][0]}); at B=4096 R=512 8x16 (hpu 256): kernel {k_ms:.4f} ms, "
              f"plain version {p_ms:.4f} ms")
    plain_crossing = time_ms(lambda: raycast.cast_rays_crossing(words, (8, 16), pos, dirs), 3)
    print(f"plain crossing cast at B=4096 R=512 8x16: {plain_crossing:.4f} ms")
    return out


def golden_frame(game, device) -> np.ndarray:
    """tests/test_golden_images.py's frame: first of seeds (1234, 7, 42, 99)
    with >= 3 colours after reset and actions 2, 0, 3."""
    import torch

    import raycastworlds_tpu_torch as rt

    for seed in (1234, 7, 42, 99):
        state = game.reset_batch(rt.rng.PRNGKey(seed, device)[None])
        for a in (2, 0, 3):
            state = game.step_batch(
                state, torch.full((1,), a, dtype=torch.int32, device=device)
            )
        frame = game.observe_batch(state)[0].cpu().numpy()
        if len(np.unique(frame)) >= 3:
            return frame
    raise RuntimeError("no structural golden frame found")


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
                    turns=True, reset_budget=0) -> dict:
    """The kernel path against each plain path on one card: kernel, the
    plains, the plains again in reverse and the kernel again (``turns``),
    or kernel then plains.  Every count is set to 0 just before the first
    kernel run and read just after it: ``kernel`` must have launched once
    per observation made and every other kernel never (``kernel`` None: no
    kernel at all).  Every run must end in the first run's state and
    checksum; for ``kernel`` None (the analytic cast, whose distances are
    not bit-exact with the crossing's) the checksums must agree to 1e-6
    relative and the reset frames on 99.9% of their values.  A budgeted
    phase must reset envs through its budget.  Returns the launches of the
    first run, by kernel."""
    import dataclasses

    import torch

    kcfg = dataclasses.replace(cfg, raycast_backend=kernel_backend)
    counters = wrappers()
    for fn in counters.values():
        fn.launches = 0
    k_state, k_sum, obs, k_s, budget = run_main_path(
        game, kcfg, num_envs, STEPS, device, reset_budget)
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: (STEPS + 1 if name == kernel else 0) for name in counters}
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, ROOT)
    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch import cuda_build
    from raycastworlds_tpu_torch.ops import raycast_crossing_kernel as rck

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

    # 3. every kernel against its plain version on the card (exact)
    measured = kernel_phase(device)

    # 4. golden frame through the crossing kernel
    golden = np.load(os.path.join(ROOT, "tests", "data", "golden_frames.npz"))
    before = rck.cast_rays_crossing_kernel.launches
    frame = golden_frame(
        rt.SingleRoom(rt.EnvConfig(num_rays=64, height_camera_view_pu=48)), device)
    check(rck.cast_rays_crossing_kernel.launches > before,
          "golden frame did not go through the kernel")
    check(frame.dtype == np.uint32 and np.array_equal(frame, golden["single_room"]),
          "golden frame differs from tests/data/golden_frames.npz")
    print(f"golden frame single_room {frame.shape} matches through the kernel")

    # 5. the main paths
    u32, pal8 = rt.EnvConfig(), rt.EnvConfig(obs_type="camera_pal8")
    check(u32.resolved_raycast_backend(device.type) == "crossing_kernel",
          "auto does not resolve to the crossing kernel on this device")
    room = dict(height_tile_map_tu=16, width_tile_map_tu=16, num_rays=256,
                height_camera_view_pu=128)
    small = dict(num_rays=64, height_camera_view_pu=64)
    phases = [
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
    ]
    launches = {name: 0 for name in KERNELS}
    for label, game, cfg, num_envs, backend, kernel, plains, kw in phases:
        run = main_path_phase(label, game, cfg, num_envs, device, backend, kernel,
                              plains, **kw)
        for name, n in run.items():
            launches[name] += n

    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": measured[name][0],
            "ms": measured[name][1],
            "plain_ms": measured[name][2],
        }
        for name, (source, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
