"""Maze against the benchmark's plain reference of it
(``benchmark/reference/maze.py``: a NumPy threefry, the binary-tree carve
and the rooms written from the published semantics, plain torch geometry),
bit for bit on the CPU: the reset's draws on square and non-square odd
maps, the packed wall words of a 17-wide map, and a budgeted
``camera_u32`` run whose budget freezes envs (every leaf, reward, end,
frame and column sum).  Imports no JAX."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import raycastworlds_tpu_torch as rt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference import maze, threefry  # noqa: E402

with open(os.path.join(ROOT, "benchmark", "configs", "maze_17x17.json")) as _f:
    ENV = json.load(_f)["env"]
SMALL = dict(ENV, num_rays=16, height_camera_view_pu=8)
SEEDS = (3, 2**33 + 17, 2**31 + 2**20 + 1)


def words(seed):
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)


def tkeys(keys):
    return torch.tensor(keys.astype(np.int64))


def _env(h, w, rooms):
    return dict(SMALL, height_tile_map_tu=h, width_tile_map_tu=w, num_rooms=rooms)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rooms", [0, 3])
@pytest.mark.parametrize("shape", [(17, 17), (9, 9), (21, 13)])
def test_reset_draws_match_the_port(shape, rooms, seed):
    """256 keys: mazes, goals, spawns, headings and next keys."""
    env = _env(*shape, rooms)
    keys = threefry.split(words(seed), 256)
    nxt, walls, goal, spawn, heading = maze.reset_draws(env, keys)
    state = rt.Maze(rt.MazeConfig(**env)).reset_batch(tkeys(keys))
    assert np.array_equal(state.rng_key.numpy(), nxt.astype(np.int64))
    assert np.array_equal(state.wall_map.numpy(), walls)
    assert np.array_equal(state.goal_tu.numpy(), goal)
    assert np.array_equal(state.pos_wu.numpy(), (spawn + 0.5).astype(np.float32))
    assert np.array_equal(state.dir_au.numpy(), heading)
    # goal and spawn are distinct empty tiles; the border stays walled
    envs = np.arange(256)
    assert not walls[envs, goal[:, 0], goal[:, 1]].any()
    assert not walls[envs, spawn[:, 0], spawn[:, 1]].any()
    assert (goal != spawn).any(axis=1).all()
    assert walls[:, [0, -1], :].all() and walls[:, :, [0, -1]].all()
    # the rooms open more than the corridors alone
    corridors = maze.reset_draws(_env(*shape, 0), keys)[1]
    assert (walls <= corridors).all()
    assert (walls.sum() < corridors.sum()) == (rooms > 0)


@pytest.mark.parametrize("seed", SEEDS)
def test_wall_words_of_a_17_wide_map(seed):
    """17-tile rows straddle the 32-bit words: each bit of the packed
    words is tile (bit // 17, bit % 17), the padding zero."""
    keys = threefry.split(words(seed), 128)
    walls = maze.reset_draws(SMALL, keys)[1]
    state = rt.Maze(rt.MazeConfig(**SMALL)).reset_batch(tkeys(keys))
    packed = state.wall_words.numpy().astype(np.int64) & 0xFFFFFFFF
    assert packed.shape == (128, -(-17 * 17 // 32))
    bits = (packed[:, :, None] >> np.arange(32)) & 1
    flat = bits.reshape(128, -1)
    assert not flat[:, 17 * 17:].any()
    assert np.array_equal(flat[:, :17 * 17].reshape(128, 17, 17).astype(bool), walls)


def test_budgeted_camera_run_matches_the_port():
    """320 envs, a budget of 256 and a 3-step limit: the truncations outrun
    the budget, so envs freeze and wait; 12 steps."""
    env = dict(SMALL, max_episode_steps=3)
    envs, steps, budget = 320, 12, 256
    port = rt.Env(rt.Maze(rt.MazeConfig(**env)), num_envs=envs, device="cpu",
                  reset_budget=budget)
    key = words(SEEDS[1])
    state, obs = port.reset(torch.tensor(key.astype(np.int64)))
    world = maze.World(env, envs, "cpu", budget)
    world.reset(threefry.split(key, envs))
    gen = torch.Generator().manual_seed(SEEDS[1])
    actions = torch.randint(0, 4, (steps, envs), generator=gen, dtype=torch.int32)
    waited = 0
    for t in range(steps + 1):
        if t:
            res = port.step(state, actions[t - 1])
            state, obs = res.state, res.obs
            reward, ended, truncated = world.step(actions[t - 1])
            assert torch.equal(res.reward, reward) and torch.equal(res.done, ended)
            assert torch.equal(res.info["truncated"], truncated)
            waited += int(state.pending_reset.sum())
        ref = world.leaves()
        for leaf, value in ref.items():
            got = getattr(state, leaf).numpy()
            assert np.array_equal(got.astype(value.dtype), value), (t, leaf)
        assert obs.dtype == torch.uint32
        frames = obs.view(torch.int32)
        assert torch.equal(frames, world.frames())
        assert torch.equal(frames.sum(dim=1, dtype=torch.int64), world.column_sums())
    assert waited > 0
