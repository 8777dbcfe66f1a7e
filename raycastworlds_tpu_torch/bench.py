"""Throughput benchmark: batched env-steps/s with camera-view observations.

    python -m raycastworlds_tpu_torch.bench              # the whole table
    python -m raycastworlds_tpu_torch.bench --num-envs 1024 --raycast pallas
    python -m raycastworlds_tpu_torch.bench --device cpu --num-envs 8 --steps 4

The port of the JAX package's ``bench.py``.  Run with no arguments it
benches the whole BASELINE table, the 17 env rows of ``SUITE`` and the 3
PPO rows of ``PPO_ROWS``, and prints ONE JSON line whose headline
``value`` is the flagship row (SingleRoom 4096 envs, 64 rays x 64 px) with
every row under ``rows`` and ``summary`` as the last key.  With any flag it
benches just that configuration.  ``vs_baseline`` is measured against the
BASELINE.json north-star target of 10M env-steps/s.

A row is ``steps_per_second_program`` (random actions, every observation
reduced to a checksum on the device): one warm-up run, then ``reps`` timed
runs, each ending on the host read of the checksum; the median rep counts.
Every row runs on the CUDA device unless ``--device`` names another; with
no card and no ``--device`` the bench raises before its first row.  The
``#`` progress lines, with each row's peak device memory, go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import torch

from . import (
    DynamicRoom,
    DynamicRoomConfig,
    Env,
    EnvConfig,
    LockedRoom,
    LockedRoomConfig,
    Maze,
    MazeConfig,
    MultiGoalConfig,
    MultiGoalRoom,
    MultiPlayerConfig,
    MultiPlayerRoom,
    RandomRoom,
    RandomRoomConfig,
    SingleRoom,
    rng,
)
from .parallel.ppo import PPOConfig, PPOTrainer
from .parallel.ppo_rnn import RecurrentPPOTrainer
from .parallel.rollout import steps_per_second_program
from .state import default_device

# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM3 bytes/s, and float32
# operations/s outside the tensor cores.  The env step is CUDA-core and HBM
# work (no matrix products), so those two ceilings are its roofline.
_H100_HBM_GBPS = 3350.0
_H100_FP32_TOPS = 67.0


def _roofline(cfg, obs: str, sps: float, device_type: str = "cuda") -> dict:
    """Lower-bound work model per env-step + % of the binding card ceiling.

    The JAX bench's work model term for term: the cast's arithmetic (DDA
    march, crossing candidates or analytic closed forms, by the backend
    ``auto`` resolves to on ``device_type``), the per-pixel render
    arithmetic and the observation-buffer traffic (written by the render,
    read by the checksum).  Everything omitted (movement, collision, reset,
    bookkeeping) only raises the true work.  The keys are the JAX line's:
    on this card "vpu" names the FP32 CUDA-core ceiling and "hbm" the HBM3
    ceiling.
    """
    r = cfg.num_rays
    hpu = cfg.height_camera_view_pu
    h, w = cfg.H, cfg.W
    nw = (h * w + 31) // 32
    # MultiPlayerRoom renders one camera per player per env-step
    players = getattr(cfg, "num_players", 1)

    backend = cfg.resolved_raycast_backend(device_type)
    if backend == "analytic":
        dda_ops = r * 40.0 * 4  # border + K boxes closed forms
    elif backend in ("crossing", "crossing_kernel", "crossing_kernel_fused"):
        dda_ops = r * (h + w) * 14.0 + 2.0 * h * w
    else:
        dda_ops = r * cfg.dda_steps * (30.0 + 2.0 * nw)

    px = hpu * r
    render_ops = 0.0
    obs_bytes = 0.0
    if obs.startswith("camera"):
        per_px = 10.0
        if cfg.wall_texture != "none":
            per_px += 25.0
        if obs == "camera_rgb":
            per_px += 6.0
            obs_bytes = px * 3.0
        elif obs == "camera_gray":
            per_px += 8.0
            obs_bytes = px * 4.0
        elif obs == "camera_gray_u8":
            per_px += 8.0
            obs_bytes = px * 1.0
        elif obs == "camera_pal8":
            obs_bytes = px * 1.0
        else:
            obs_bytes = px * 4.0
        render_ops = px * per_px + r * 30.0
    elif obs == "depth":
        render_ops = r * 10.0
        obs_bytes = r * 4.0
    hbm_bytes = 2.0 * obs_bytes * players

    vpu_ops = (dda_ops + render_ops) * players
    bound_vpu = _H100_FP32_TOPS * 1e12 / max(vpu_ops, 1.0)
    bound_hbm = _H100_HBM_GBPS * 1e9 / max(hbm_bytes, 1.0)
    binding = "vpu" if bound_vpu < bound_hbm else "hbm"
    return {
        "vpu_ops_per_step": round(vpu_ops),
        "hbm_bytes_per_step": round(hbm_bytes),
        "sps_bound_vpu": round(bound_vpu),
        "sps_bound_hbm": round(bound_hbm),
        "binding": binding,
        "frac_of_roofline": round(sps / min(bound_vpu, bound_hbm), 4),
    }


def build_env(
    game: str = "single_room",
    num_envs: int = 4096,
    num_rays: int = 64,
    height_px: int = 64,
    obs: str = "camera_u32",
    texture: str = "none",
    map_h: int = 0,
    map_w: int = 0,
    flood_iters: int = -1,
    reset_budget: int = 0,
    raycast: str = "auto",
    *,
    device=None,
    mesh=None,
) -> Env:
    """The benchmark Env of one workload row (shared with
    ``bench_scaling``).  ``raycast`` defaults to "auto", the dispatch users
    get with no flags; ``device`` None is the CUDA device (raising where
    there is none), ``mesh`` a dp mesh whose device the env takes."""
    kw = dict(num_rays=num_rays, height_camera_view_pu=height_px, obs_type=obs,
              raycast_backend=raycast, wall_texture=texture)
    maps = {}
    if map_h:
        maps["height_tile_map_tu"] = map_h
    if map_w:
        maps["width_tile_map_tu"] = map_w
    if game == "random_room":
        g = RandomRoom(RandomRoomConfig(height_tile_map_tu=map_h or 16,
                                        width_tile_map_tu=map_w or 16,
                                        flood_iters=flood_iters, **kw))
    elif game == "maze":
        g = Maze(MazeConfig(height_tile_map_tu=map_h or 17, width_tile_map_tu=map_w or 17,
                            **kw))
    else:
        families = {
            "single_room": (SingleRoom, EnvConfig),
            "multi_goal": (MultiGoalRoom, MultiGoalConfig),
            "locked_room": (LockedRoom, LockedRoomConfig),
            "dynamic_room": (DynamicRoom, DynamicRoomConfig),
            "multi_player": (MultiPlayerRoom, MultiPlayerConfig),
        }
        if game not in families:
            raise ValueError(f"unknown game {game}")
        family, config = families[game]
        g = family(config(**kw, **maps))
    return Env(g, num_envs=num_envs, reset_budget=reset_budget, device=device, mesh=mesh)


def device_name(device: torch.device) -> str:
    """The card's name, or the device type for any other device."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def run_one(
    game: str = "single_room",
    num_envs: int = 4096,
    num_rays: int = 64,
    height_px: int = 64,
    steps: int = 512,
    reps: int = 4,
    obs: str = "camera_u32",
    texture: str = "none",
    map_h: int = 0,
    map_w: int = 0,
    flood_iters: int = -1,
    reset_budget: int = 0,
    raycast: str = "auto",
    *,
    device=None,
) -> dict:
    """Benchmark one configuration; returns the result row dict."""
    env = build_env(
        game=game, num_envs=num_envs, num_rays=num_rays, height_px=height_px, obs=obs,
        texture=texture, map_h=map_h, map_w=map_w, flood_iters=flood_iters,
        reset_budget=reset_budget, raycast=raycast, device=device,
    )
    cfg = env.cfg

    state, _ = env.reset(rng.PRNGKey(0))
    run = steps_per_second_program(env, steps)

    # warm-up; every run ends on the host read of the checksum, which waits
    # for the card to finish the program
    key = rng.PRNGKey(1)
    state, acc = run(state, key)
    float(acc)

    times = []
    for r in range(reps):
        key = rng.fold_in(key, r)
        t0 = time.perf_counter()
        state, acc = run(state, key)
        float(acc)
        times.append(time.perf_counter() - t0)

    # the median rep, not the best: the minimum flatters one lucky window
    med = sorted(times)[len(times) // 2]
    sps = num_envs * steps / med

    return {
        "metric": "env_steps_per_sec",
        "value": round(sps, 1),
        "unit": "steps/s",
        "vs_baseline": round(sps / 1e7, 4),
        "roofline": _roofline(cfg, obs, sps, env.device.type),
        "config": {
            "game": game,
            "num_envs": num_envs,
            "num_rays": num_rays,
            "height_px": height_px,
            "obs": obs,
            "scan_steps": steps,
            "reset_budget": reset_budget,
            "device": device_name(env.device),
            "raycast_backend": cfg.raycast_backend,
            "resolved_backend": cfg.resolved_raycast_backend(env.device.type),
        },
        "times_s": [round(t, 4) for t in times],
        "checksum": float(acc),
    }


# The standing benchmark table, the JAX bench's rows: every BASELINE.json
# config that runs on one device, plus the per-family rows.  (BASELINE
# configs 1 and 5 are not throughput rows: config 1 is the CPU parity
# harness, config 5 the scaling benchmark, ``bench_scaling``.)
SUITE = [
    # name, kwargs
    ("flagship_single_room_4096", dict()),
    ("config2_single_room_1024", dict(num_envs=1024)),
    ("config3_random_16x16_rgb128", dict(
        game="random_room", num_envs=8192, num_rays=256, height_px=128,
        obs="camera_rgb", reset_budget=256, steps=128, reps=3)),
    ("config3_u32_variant", dict(
        game="random_room", num_envs=8192, num_rays=256, height_px=128,
        obs="camera_u32", reset_budget=256, steps=128, reps=3)),
    ("config4_maze_32k", dict(
        game="maze", num_envs=32768, reset_budget=512, steps=256, reps=3)),
    ("multi_goal_8192", dict(game="multi_goal", num_envs=8192, reps=3)),
    ("dynamic_room_8192", dict(game="dynamic_room", num_envs=8192, reps=3)),
    ("locked_room_8192", dict(game="locked_room", num_envs=8192, reps=3)),
    ("ref_default_res_512x256", dict(
        num_envs=1024, num_rays=512, height_px=256, steps=128, reps=3)),
    ("single_room_48x48_map", dict(
        map_h=48, map_w=48, reps=3)),
    ("single_room_32k", dict(num_envs=32768, reps=3)),
    ("multi_player_2p_4096", dict(
        game="multi_player", num_envs=4096, reps=3)),
    # 1-byte lossless palette-index observations
    ("flagship_pal8_4096", dict(obs="camera_pal8")),
    ("config3_pal8", dict(
        game="random_room", num_envs=8192, num_rays=256, height_px=128,
        obs="camera_pal8", reset_budget=256, steps=128, reps=3)),
    ("ref_default_res_pal8", dict(
        num_envs=1024, num_rays=512, height_px=256, obs="camera_pal8",
        steps=128, reps=3)),
    # the crossing kernels asked for by name
    ("config3_pal8_kernel", dict(
        game="random_room", num_envs=8192, num_rays=256, height_px=128,
        obs="camera_pal8", reset_budget=256, steps=128, reps=3,
        raycast="crossing_kernel_fused")),
    ("ref_default_pal8_kernel_4096", dict(
        num_envs=4096, num_rays=512, height_px=256, obs="camera_pal8",
        steps=64, reps=3, raycast="crossing_kernel")),
]


def run_ppo_row(
    name: str = "ppo_train_step_mlp_bf16",
    trunk: str = "mlp",
    obs: str = "camera_gray",
    num_envs: int = 2048,
    num_epochs: int = 0,
    recurrent: bool = False,
    *,
    device=None,
) -> dict:
    """Learner-in-the-loop row: env-steps/s through the whole PPO train
    step (rollout + GAE + clipped update) of SingleRoom at 64 rays x 64 px,
    hidden 256 in bfloat16, rollout 64: one warm-up update, then 6 timed
    ones ending on the host read of the last loss."""
    rollout_steps, updates = 64, 6
    cfg = EnvConfig(num_rays=64, height_camera_view_pu=64, obs_type=obs)
    env = Env(SingleRoom(cfg), num_envs=num_envs, device=device)
    ppo_cfg = PPOConfig(rollout_steps=rollout_steps)
    if num_epochs:
        ppo_cfg = ppo_cfg._replace(num_epochs=num_epochs)
    cls = RecurrentPPOTrainer if recurrent else PPOTrainer
    trainer = cls(env, ppo_cfg, hidden=256, dtype=torch.bfloat16, trunk=trunk)
    ts = trainer.init(rng.PRNGKey(0))
    ts, metrics = trainer.train_step(ts)  # warm-up
    float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(updates):
        ts, metrics = trainer.train_step(ts)
    float(metrics["loss"])
    dt = time.perf_counter() - t0
    sps = num_envs * rollout_steps * updates / dt
    return {
        "name": name,
        "metric": "ppo_env_steps_per_sec",
        "value": round(sps, 1),
        "unit": "steps/s (through full PPO train step)",
        "config": {
            "num_envs": num_envs, "rollout_steps": rollout_steps,
            "obs": obs, "hidden": 256, "dtype": "bfloat16",
            "trunk": trunk, "recurrent": recurrent,
            "num_epochs": ppo_cfg.num_epochs,
            "device": device_name(env.device),
        },
        "seconds": round(dt, 3),
    }


PPO_ROWS = [
    # default learner config (mlp trunk, bf16, 2 epochs)
    dict(name="ppo_train_step_mlp_bf16"),
    # max-throughput preset (1-byte luma obs, 1 epoch, 4096 envs)
    dict(name="ppo_train_step_throughput", obs="camera_gray_u8", num_envs=4096,
         num_epochs=1),
    # the recurrent GRU trainer
    dict(name="ppo_train_step_recurrent_gru", recurrent=True),
]


def _progress(name: str, row: dict, device: torch.device) -> None:
    """The row's ``#`` line on stderr, with the peak device memory of the
    row on a card."""
    msg = f"{row['value']:.0f} steps/s" if "value" in row else row.get("error", "?")
    if device.type == "cuda":
        msg += (f", peak device memory "
                f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    print(f"# {name}: {msg}", file=sys.stderr, flush=True)


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def run_suite(rows=SUITE, ppo_rows=PPO_ROWS, device=None) -> dict:
    """Bench ``rows`` ((name, run_one kwargs) pairs) and ``ppo_rows``
    (run_ppo_row kwargs) on ``device`` (None: the CUDA device, raising
    before the first row where there is none); a row that raises is
    recorded as ``{"name", "error"}``.  Prints the one JSON line and
    returns it."""
    device = default_device(device, "the bench")
    out = []
    for name, kw in rows:
        _reset_peak(device)
        try:
            row = run_one(**kw, device=device)
            row["name"] = name
            out.append(row)
        except Exception as e:  # record the failure, keep the table
            out.append({"name": name, "error": f"{type(e).__name__}: {e}"})
        _progress(name, out[-1], device)
    for kw in ppo_rows:
        _reset_peak(device)
        try:
            out.append(run_ppo_row(**kw, device=device))
        except Exception as e:
            out.append({"name": kw["name"], "error": f"{type(e).__name__}: {e}"})
        _progress(kw["name"], out[-1], device)
    head = out[0] if out and "value" in out[0] else {}
    # `summary` is deliberately the LAST key: json.dumps keeps insertion
    # order, so a capture of the line's tail keeps every row's headline
    # number even when the per-row detail above it is cut
    summary = {}
    for row in out:
        if "value" in row:
            frac = (row.get("roofline") or {}).get("frac_of_roofline")
            summary[row["name"]] = [row["value"], frac] if frac is not None else [row["value"]]
        else:
            summary[row["name"]] = row.get("error", "?")[:60]
    result = {
        "metric": "env_steps_per_sec",
        "value": head.get("value"),
        "unit": "steps/s",
        "vs_baseline": head.get("vs_baseline"),
        "roofline": head.get("roofline"),
        "config": head.get("config"),
        "times_s": head.get("times_s"),
        "checksum": head.get("checksum"),
        "rows": out,
        "summary": summary,
    }
    print(json.dumps(result), flush=True)
    return result


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--num-rays", type=int, default=64)
    p.add_argument("--height-px", type=int, default=64)
    p.add_argument("--steps", type=int, default=512, help="steps per program run")
    p.add_argument("--reps", type=int, default=4, help="timed program executions")
    p.add_argument("--obs", type=str, default="camera_u32")
    p.add_argument("--game", type=str, default="single_room",
                   choices=["single_room", "random_room", "maze", "multi_goal",
                            "dynamic_room", "multi_player", "locked_room"])
    p.add_argument("--texture", type=str, default="none",
                   help="wall texture: none|checker|brick|xor")
    p.add_argument("--map-h", type=int, default=0, help="override map height")
    p.add_argument("--map-w", type=int, default=0, help="override map width")
    p.add_argument("--flood-iters", type=int, default=-1,
                   help="random_room reachability budget")
    p.add_argument("--reset-budget", type=int, default=0,
                   help="budgeted auto-reset (0 = dense)")
    p.add_argument("--raycast", type=str, default="auto",
                   help="auto|crossing|crossing_kernel|crossing_kernel_fused"
                        "|scan|scan_flat|analytic|pallas|fused")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device)")
    return p.parse_args(argv)


def main(argv: Optional[list] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    device = default_device(args.device, "the bench")
    if not argv:
        run_suite(device=device)
        return
    _reset_peak(device)
    result = run_one(
        game=args.game, num_envs=args.num_envs, num_rays=args.num_rays,
        height_px=args.height_px, steps=args.steps, reps=args.reps, obs=args.obs,
        texture=args.texture, map_h=args.map_h, map_w=args.map_w,
        flood_iters=args.flood_iters, reset_budget=args.reset_budget,
        raycast=args.raycast, device=device,
    )
    _progress(args.game, result, device)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
