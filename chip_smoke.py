#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``raycastworlds_tpu_torch/csrc`` and drives the
port's main path, ``Env(SingleRoom(EnvConfig()))`` with dense auto-reset, on
the card.  Phases, each printing a line:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. the kernel build and its seconds;
3. the crossing-cast kernel against its plain PyTorch version on the card,
   exact on all four outputs, at the reference-default shape (4096 envs x
   512 rays, 8x16 map), at maps 13x9, 24x40 and 48x48, and on rays with an
   exact-zero direction component from integer positions; plus both times;
4. the golden frame of tests/data/golden_frames.npz ("single_room", pinned
   from the JAX package) reproduced through the kernel;
5. the main path: 4096 envs, 512 rays x 256 px, camera_u32, reset plus 64
   steps of the throughput program, through the kernel (launch count = casts
   made) and through the plain crossing cast; final states and checksums
   identical; env-steps/s of both.  Then camera_pal8 at 1024 envs.

The line before the last is the kernels' JSON record; the last line is
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
KERNEL_SOURCE = "raycastworlds_tpu_torch/csrc/crossing_cast.cu"
KERNEL_REPLACES = "raycastworlds_tpu/ops/raycast_crossing_kernel.py:113"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def fuzz_inputs(h, w, b, r, seed, device, sliding=False):
    """Packed random maps (border walls, interior walls at density 0.25),
    random interior positions and random unit directions, from
    numpy.random.default_rng(seed).  ``sliding``: integer positions and
    axis-parallel rays (an exact-zero component) for every ray."""
    import torch

    from raycastworlds_tpu_torch.ops.bitmap import pack_bits_np

    rng = np.random.default_rng(seed)
    maps = rng.random((b, h, w)) < 0.25
    maps[:, 0, :] = maps[:, -1, :] = True
    maps[:, :, 0] = maps[:, :, -1] = True
    words = pack_bits_np(maps).view(np.int32)
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


def compare_kernel(h, w, b, r, seed, device, sliding=False) -> float:
    """Kernel vs plain version on one input set; returns the max abs error
    over all four outputs (required to be 0)."""
    import torch

    from raycastworlds_tpu_torch.ops import raycast_crossing_kernel as rck

    words, pos, dirs = fuzz_inputs(h, w, b, r, seed, device, sliding)
    k_tu, k_dim, k_dist = rck.cast_rays_crossing_kernel(words, (h, w), pos, dirs)
    p_tu, p_dim, p_dist = rck.cast_rays_crossing_kernel_ref(words, (h, w), pos, dirs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    err = max(
        float((k_dist - p_dist).abs().max()),
        float((k_tu - p_tu).abs().max()),
        float((k_dim - p_dim).abs().max()),
    )
    same = (
        torch.equal(k_dist, p_dist) and torch.equal(k_tu, p_tu)
        and torch.equal(k_dim, p_dim)
    )
    check(same and err == 0.0,
          f"kernel != plain at {h}x{w}, B={b}, R={r}, sliding={sliding}: max err {err}")
    return err


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


def run_main_path(cfg, num_envs, steps, device):
    """Reset + ``steps`` steps of the throughput program; returns
    (final state, checksum, obs of the reset, seconds of the steps).  The
    timed region ends on the host read of the checksum."""
    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.parallel import rollout

    env = rt.Env(rt.SingleRoom(cfg), num_envs=num_envs, device=device)
    state, obs = env.reset(rt.rng.PRNGKey(SEED))
    run = rollout.steps_per_second_program(env, steps)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, acc = run(state, rt.rng.PRNGKey(SEED + 1))
    checksum = float(acc)
    seconds = time.perf_counter() - t0
    return state, checksum, obs, seconds


def same_state(a, b) -> bool:
    import torch

    return all(torch.equal(x, b.leaves()[k]) for k, x in a.leaves().items())


def main_path_phase(cfg, num_envs, steps, device, label):
    """Kernel path, plain path, plain path, kernel path (alternating, on one
    card); the kernel's launches are counted over the first run only."""
    import dataclasses

    from raycastworlds_tpu_torch.ops import raycast_crossing_kernel as rck

    kcfg = cfg
    pcfg = dataclasses.replace(cfg, raycast_backend="crossing")
    check(kcfg.resolved_raycast_backend(device.type) == "crossing_kernel",
          "auto does not resolve to the kernel on this device")
    rck.cast_rays_crossing_kernel.launches = 0
    k_state, k_sum, obs, k_s = run_main_path(kcfg, num_envs, steps, device)
    launches = rck.cast_rays_crossing_kernel.launches
    check(launches == steps + 1,
          f"{label}: {launches} kernel launches for {steps + 1} casts")
    check(tuple(obs.shape) == (num_envs,) + cfg.obs_shape,
          f"{label}: obs shape {tuple(obs.shape)}")
    check(math.isfinite(k_sum), f"{label}: checksum {k_sum}")
    times = {"kernel": [k_s], "plain": []}
    for backend_cfg, key in ((pcfg, "plain"), (pcfg, "plain"), (kcfg, "kernel")):
        st, sm, _, s = run_main_path(backend_cfg, num_envs, steps, device)
        check(same_state(st, k_state) and sm == k_sum,
              f"{label}: {key} path final state/checksum differ ({sm} vs {k_sum})")
        times[key].append(s)
    rates = {k: [num_envs * steps / s for s in v] for k, v in times.items()}
    print(f"main path {label}: {num_envs} envs x {steps} steps, obs "
          f"{tuple(obs.shape)} {obs.dtype}, checksum {k_sum!r} (kernel == plain), "
          f"kernel launches {launches}")
    print(f"main path {label} env-steps/s: kernel "
          f"{', '.join(f'{x:.1f}' for x in rates['kernel'])}; plain crossing "
          f"{', '.join(f'{x:.1f}' for x in rates['plain'])}")
    return launches, obs.dtype


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, ROOT)
    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch import cuda_build
    from raycastworlds_tpu_torch.ops import raycast, raycast_crossing_kernel as rck

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
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")

    # 3. kernel vs plain version on the card (exact)
    errs = [compare_kernel(8, 16, 4096, 512, SEED, device)]
    for h, w in ((13, 9), (24, 40), (48, 48)):
        errs.append(compare_kernel(h, w, 512, 512, SEED + h, device))
    errs.append(compare_kernel(8, 16, 256, 512, SEED + 1, device, sliding=True))
    errs.append(compare_kernel(24, 40, 256, 333, SEED + 2, device, sliding=True))
    max_err = max(errs)
    words, pos, dirs = fuzz_inputs(8, 16, 4096, 512, SEED, device)
    k_ms = time_ms(lambda: rck.cast_rays_crossing_kernel(words, (8, 16), pos, dirs), 50)
    ref_ms = time_ms(
        lambda: rck.cast_rays_crossing_kernel_ref(words, (8, 16), pos, dirs), 10)
    plain_ms = time_ms(
        lambda: raycast.cast_rays_crossing(words, (8, 16), pos, dirs), 10)
    print(f"kernel == plain on 6 input sets (max abs err {max_err}); cast at "
          f"B=4096 R=512 8x16: kernel {k_ms:.4f} ms, its plain version "
          f"{ref_ms:.4f} ms, plain crossing cast {plain_ms:.4f} ms")

    # 4. golden frame through the kernel
    golden = np.load(os.path.join(ROOT, "tests", "data", "golden_frames.npz"))
    before = rck.cast_rays_crossing_kernel.launches
    frame = golden_frame(
        rt.SingleRoom(rt.EnvConfig(num_rays=64, height_camera_view_pu=48)), device)
    check(rck.cast_rays_crossing_kernel.launches > before,
          "golden frame did not go through the kernel")
    check(frame.dtype == np.uint32 and np.array_equal(frame, golden["single_room"]),
          "golden frame differs from tests/data/golden_frames.npz")
    print(f"golden frame single_room {frame.shape} matches through the kernel")

    # 5. the main path, then pal8
    launches, _ = main_path_phase(rt.EnvConfig(), 4096, 64, device, "camera_u32")
    main_path_phase(rt.EnvConfig(obs_type="camera_pal8"), 1024, 64, device,
                    "camera_pal8")

    print(json.dumps({"kernels": [{
        "name": "crossing_cast",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": ref_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
