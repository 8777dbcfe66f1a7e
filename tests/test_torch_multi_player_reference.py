"""MultiPlayerRoom against the benchmark's plain reference of it
(``benchmark/reference/multi_player.py``: a NumPy threefry, the player
rules and the sprite render written from the published semantics, plain
torch geometry), bit for bit on the CPU: the reset's draws for 2 and 3
players, and a dense-reset ``camera_u32`` run in a room small enough that
players block and converge (every leaf, reward, end, frame and column sum),
with player collision on and off.  Imports no JAX."""

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

from benchmark.reference import multi_player, threefry  # noqa: E402

with open(os.path.join(ROOT, "benchmark", "configs", "multi_player_2p.json")) as _f:
    ENV = json.load(_f)["env"]
# a 3 x 4 interior: the players meet often, and reach the goal now and then
SMALL = dict(ENV, num_rays=16, height_camera_view_pu=16, height_tile_map_tu=5,
             width_tile_map_tu=6)
SEEDS = (3, 2**33 + 17, 2**31 + 2**20 + 1)


def words(seed):
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("players", [2, 3])
def test_reset_draws_match_the_port(players, seed):
    """256 keys on the cell's 8 x 16 room: goals, spawns, headings and next
    keys; every spawn a distinct interior tile off the goal."""
    env = dict(ENV, num_rays=16, height_camera_view_pu=16, num_players=players)
    keys = threefry.split(words(seed), 256)
    nxt, goal, spawns, headings = multi_player.reset_draws(multi_player.Spec(env), keys)
    state = rt.MultiPlayerRoom(rt.MultiPlayerConfig(**env)).reset_batch(
        torch.tensor(keys.astype(np.int64)))
    assert np.array_equal(state.rng_key.numpy(), nxt.astype(np.int64))
    assert np.array_equal(state.goal_tu.numpy(), goal)
    assert np.array_equal(state.pos_wu.numpy(), (spawns + 0.5).astype(np.float32))
    assert np.array_equal(state.dir_au.numpy(), headings)
    tiles = np.concatenate([goal[:, None], spawns], axis=1)        # [n, 1 + P, 2]
    ranks = tiles[..., 0] * 16 + tiles[..., 1]
    assert all(len(set(r)) == players + 1 for r in ranks.tolist())
    assert ((tiles >= 1) & (tiles <= [6, 14])).all()


@pytest.mark.parametrize("collision", [True, False])
def test_dense_camera_run_matches_the_port(collision):
    """64 envs, 40 steps of uniform actions: every leaf after each step,
    the rewards, ends, frames and column sums."""
    env = dict(SMALL, player_collision=collision)
    envs, steps = 64, 40
    port = rt.Env(rt.MultiPlayerRoom(rt.MultiPlayerConfig(**env)), num_envs=envs,
                  device="cpu")
    key = words(SEEDS[1])
    state, obs = port.reset(torch.tensor(key.astype(np.int64)))
    world = multi_player.World(env, envs, "cpu")
    world.reset(threefry.split(key, envs))
    gen = torch.Generator().manual_seed(SEEDS[1])
    actions = torch.randint(0, 4, (steps, envs, 2), generator=gen, dtype=torch.int32)
    yielded = ends = sprite_px = 0
    for t in range(steps + 1):
        if t:
            res = port.step(state, actions[t - 1])
            state, obs = res.state, res.obs
            reward, ended, truncated = world.step(actions[t - 1])
            assert torch.equal(res.reward.sum(dim=-1), reward) and torch.equal(res.done, ended)
            assert torch.equal(res.info["truncated"], truncated)
            yielded += int(world.yielded.sum())
            ends += int(ended.sum())
        for leaf, value in world.leaves().items():
            got = getattr(state, leaf).numpy()
            assert np.array_equal(got.astype(value.dtype), value), (t, leaf)
        assert obs.dtype == torch.uint32 and obs.shape == (envs, 2, 16, 16)
        frames = obs.view(torch.int32)
        assert torch.equal(frames, world.frames())
        assert torch.equal(frames.sum(dim=2, dtype=torch.int64), world.column_sums())
        sprite_px += int((frames == multi_player.TILE_BLOCK).sum())
    # the cases are not vacuous: sprites show, episodes end, and with
    # collision on the lower-index rule blocks a converging move
    assert sprite_px > 0 and ends > 0
    assert (yielded > 0) == collision
