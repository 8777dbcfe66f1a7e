"""RandomRoom against the benchmark's plain reference of it
(``benchmark/reference/random_room.py``: a NumPy threefry, a breadth-first
reachability search, plain torch geometry), bit for bit on the CPU: the
reset's draws, the reachable set, and a budgeted ``camera_rgb`` run whose
budget freezes envs (every leaf, reward, end, frame and column sum).
Imports no JAX."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch.ops import flood

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference import random_room, threefry  # noqa: E402

with open(os.path.join(ROOT, "benchmark", "configs", "random_room_rgb.json")) as _f:
    ENV = json.load(_f)["env"]
SMALL = dict(ENV, num_rays=32, height_camera_view_pu=16)
SEED = 2**34 + 5


def words(seed):
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)


def tkeys(keys):
    return torch.tensor(keys.astype(np.int64))


@pytest.mark.parametrize("density", [0.2, 0.6])
def test_reset_draws_match_the_port(density):
    """512 keys: maps, goals, spawns, headings and next keys; some goals
    are walled in at either density, and spawn beside the goal."""
    env = dict(SMALL, wall_density=density)
    keys = threefry.split(words(SEED), 512)
    nxt, walls, goal, spawn, heading = random_room.reset_draws(env, keys)
    state = rt.RandomRoom(rt.RandomRoomConfig(**env)).reset_batch(tkeys(keys))
    assert np.array_equal(state.rng_key.numpy(), nxt.astype(np.int64))
    assert np.array_equal(state.wall_map.numpy(), walls)
    assert np.array_equal(state.goal_tu.numpy(), goal)
    assert np.array_equal(state.pos_wu.numpy(), (spawn + 0.5).astype(np.float32))
    assert np.array_equal(state.dir_au.numpy(), heading)
    # a walled-in goal (its four neighbours walled on the drawn map): the
    # spawn is the tile above it, below it in row 1
    drawn = random_room.uniforms(threefry.split(keys, 5)[:, 1], 16 * 16) < np.float32(density)
    drawn = drawn.reshape(512, 16, 16)
    drawn[:, [0, -1], :] = True
    drawn[:, :, [0, -1]] = True
    gi, gj = goal[:, 0], goal[:, 1]
    walled_in = (drawn[np.arange(512), gi - 1, gj] & drawn[np.arange(512), gi + 1, gj]
                 & drawn[np.arange(512), gi, gj - 1] & drawn[np.arange(512), gi, gj + 1])
    assert walled_in.any()
    want = np.stack([np.where(gi > 1, gi - 1, gi + 1), gj], axis=-1)
    assert np.array_equal(spawn[walled_in], want[walled_in])


@pytest.mark.parametrize("shape,density", [((16, 16), 0.3), ((7, 9), 0.4)])
def test_reachable_set_matches_the_fill(shape, density):
    h, w = shape
    gen = torch.Generator().manual_seed(11)
    passable = torch.rand((64, h, w), generator=gen) >= density
    seed = torch.stack([torch.randint(0, h, (64,), generator=gen),
                        torch.randint(0, w, (64,), generator=gen)], dim=-1).to(torch.int32)
    got = flood.flood_fill(passable, seed).numpy()
    want = np.stack([random_room.reachable(passable[e].numpy(), seed[e].numpy(),
                                           h * w // 2 + 2) for e in range(64)])
    assert np.array_equal(got, want)
    assert want.sum() > 64  # the fills spread beyond their seeds
    # a bounded fill: at most 3 moves from the seed
    got3 = flood.flood_fill(passable, seed, 3).numpy()
    want3 = np.stack([random_room.reachable(passable[e].numpy(), seed[e].numpy(), 3)
                      for e in range(64)])
    assert np.array_equal(got3, want3) and want3.sum() < want.sum()


def test_budgeted_rgb_run_matches_the_port():
    """64 envs, a budget of 4 and a 6-step limit: the truncations outrun the
    budget, so envs freeze and wait; 40 steps."""
    env = dict(SMALL, max_episode_steps=6)
    envs, steps, budget = 64, 40, 4
    port = rt.Env(rt.RandomRoom(rt.RandomRoomConfig(**env)), num_envs=envs, device="cpu",
                  reset_budget=budget)
    key = words(SEED)
    state, obs = port.reset(torch.tensor(key.astype(np.int64)))
    world = random_room.World(env, envs, "cpu", budget)
    world.reset(threefry.split(key, envs))
    gen = torch.Generator().manual_seed(SEED)
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
        frames = world.frames()
        assert obs.dtype == torch.uint8 and torch.equal(obs, frames)
        assert torch.equal(obs.sum(dim=1, dtype=torch.int64), world.column_sums())
    assert waited > 0
