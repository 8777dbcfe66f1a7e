"""The port's example scripts: each runs as ``python -m`` in a subprocess
with ``--device cpu`` at tiny shapes and prints one parseable JSON line;
the rollout demo's env steps, episodes and returns equal the JAX package's
``examples/rollout_demo.py`` run with the same flags on the CPU (exact:
they follow from the states alone).  Also: without ``--device`` the
examples run on the card, and raise where there is none; and
``bench_scaling.build_env``'s new ``raycast`` argument leaves its default
build as it was."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch import bench_scaling
from raycastworlds_tpu_torch.examples import (
    multi_player_demo, profile_ppo, profile_step, rollout_demo)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--num-rays", "16", "--height-px", "16"]
ROLLOUT = ["--game", "random_room", "--num-envs", "64", "--chunk-steps", "32",
           "--chunks", "3"] + TINY


def _run(args, timeout=300) -> dict:
    out = subprocess.run([sys.executable] + args, capture_output=True, text=True,
                         timeout=timeout, cwd=ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    return json.loads(lines[0])


def _module(name, *args) -> dict:
    return _run(["-m", f"raycastworlds_tpu_torch.examples.{name}", "--device", "cpu",
                 *args])


def test_rollout_demo_matches_jax():
    got = _module("rollout_demo", *ROLLOUT)
    want = _run(["examples/rollout_demo.py", "--backend", "cpu", *ROLLOUT])
    assert sorted(got) == sorted(want)
    assert got["env_steps"] == want["env_steps"] == 64 * 32 * 3
    assert got["episodes"] == want["episodes"] > 0
    assert got["mean_return"] == want["mean_return"]


def test_multi_player_demo(tmp_path):
    got = _module("multi_player_demo", "--num-envs", "2", "--steps", "6", "--out",
                  str(tmp_path), *TINY)
    assert got["players"] == 2 and len(got["per_player_return"]) == 2
    assert sorted(os.listdir(tmp_path)) == [
        "player0_camera.png", "player1_camera.png", "top_view.png"]
    assert (tmp_path / "top_view.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_profile_step(tmp_path):
    got = _module("profile_step", "--num-envs", "4", "--steps", "3", "--top", "5",
                  "--trace-dir", str(tmp_path / "trace"), *TINY)
    assert got["events"].startswith("CPU operators") and len(got["kernels"]) == 5
    assert got["wall_ms_per_step"] > 0 and got["device_ms_per_step"] > 0
    assert got["kernels"][0]["calls"] > 0
    # the resets draw their randomness through threefry, and the labels that
    # profile_step patches in reach it: the hash is most of the reset's time
    # (about 94% here and on the card), so a call that bypasses the patched
    # ``rng.threefry2x32`` would show as a share far below that
    within = {k: v["ms_per_step"] for k, v in got["within"].items()}
    assert 0 < within["reset_batch"] and 0.5 * within["reset_batch"] < within["threefry"]
    assert os.path.exists(tmp_path / "trace" / "trace.json")


def test_profile_ppo():
    got = _module("profile_ppo", "--num-envs", "8", "--rollout-steps", "4", "--hidden",
                  "16", "--trunk", "mlp", "--reps", "1", *TINY)
    assert sorted(got["times_ms"]) == sorted([
        "full", "rollout", "update", "env_only", "infer_only", "update_1ep",
        "update_noshuf", "grad_mb"])
    assert all(v > 0 for v in got["times_ms"].values())
    assert got["env_steps_per_update"] == 32


@pytest.mark.parametrize("example", [rollout_demo, multi_player_demo, profile_step,
                                     profile_ppo])
def test_examples_default_to_the_card(example):
    if torch.cuda.is_available():
        pytest.skip("checks the default where there is no card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        example.main(TINY)


def test_build_env_default_unchanged():
    """The default build is untextured under ``auto`` with RandomRoom's own
    flood budget, as before ``raycast``."""
    for game in ("single_room", "random_room", "maze", "multi_goal", "dynamic_room",
                 "locked_room", "multi_player"):
        env = bench_scaling.build_env(game, num_envs=2, num_rays=8, height_px=8,
                                      device="cpu")
        cfg = env.cfg
        assert cfg.raycast_backend == "auto" and cfg.wall_texture == "none", game
        assert (cfg.num_rays, cfg.height_camera_view_pu, cfg.obs_type) == (8, 8, "camera_u32")
        if game == "random_room":
            assert cfg.flood_iters == -1
            assert dataclasses.replace(cfg) == rt.RandomRoomConfig(
                height_tile_map_tu=16, width_tile_map_tu=16, num_rays=8,
                height_camera_view_pu=8)
    env = bench_scaling.build_env("random_room", 2, 8, 8, raycast="scan", device="cpu")
    assert env.cfg.raycast_backend == "scan"
    assert bench_scaling.build_env(num_envs=2, device="cpu").cfg == rt.EnvConfig(
        num_rays=64, height_camera_view_pu=64)
