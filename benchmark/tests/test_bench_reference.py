"""The plain reference against the port on the CPU at small sizes: the
same draws, the same trajectories, the same frames, bit for bit."""

import numpy as np
import pytest
import torch

import raycastworlds_tpu_torch as rt
from benchmark import harness
from benchmark.reference import single_room, threefry

SEED = 2**33 + 17


def words(seed):
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)


def test_threefry_draws_match_the_port():
    key = words(SEED)
    tkey = torch.tensor(key.astype(np.int64))
    keys = threefry.split(key, 64)
    assert np.array_equal(keys.astype(np.int64), rt.rng.split(tkey, 64).numpy())
    tkeys = torch.tensor(keys.astype(np.int64))
    assert np.array_equal(threefry.randint(keys, 2, [1, 1], [7, 15]),
                          rt.rng.randint(tkeys, (2,), [1, 1], [7, 15]).numpy())
    assert np.array_equal(threefry.uniform(keys), rt.rng.uniform(tkeys, ()).numpy())
    assert np.array_equal(threefry.key_of_seed(12345).astype(np.int64),
                          rt.rng.PRNGKey(12345).numpy())


@pytest.mark.parametrize("name,envs,steps", [("single_room_64", 48, 120),
                                             ("single_room_512x256", 4, 40)])
def test_trajectory_matches_the_port(name, envs, steps):
    env_cfg = harness.load_config(name)["env"]
    env = rt.Env(rt.SingleRoom(rt.EnvConfig(**env_cfg)), num_envs=envs, device="cpu")
    key = words(SEED)
    state, obs = env.reset(torch.tensor(key.astype(np.int64)))
    world = single_room.World(env_cfg, envs, "cpu")
    world.reset(threefry.split(key, envs))
    gen = torch.Generator().manual_seed(SEED)
    actions = torch.randint(0, 4, (steps, envs), generator=gen, dtype=torch.int32)
    for t in range(steps + 1):
        if t:
            res = env.step(state, actions[t - 1])
            state, obs = res.state, res.obs
            reward, ended, _ = world.step(actions[t - 1])
            assert torch.equal(res.reward, reward) and torch.equal(res.done, ended)
        ref = world.leaves()
        for leaf, value in ref.items():
            assert np.array_equal(getattr(state, leaf).numpy().astype(value.dtype), value), leaf
        frames = world.frames()
        assert torch.equal(obs.view(torch.int32), frames)
        assert torch.equal(frames.sum(dim=1, dtype=torch.int64), world.column_sums())


def test_episodes_end_and_reset():
    """Random actions end some episodes in a few hundred steps (the check
    then covers the auto-reset)."""
    env_cfg = harness.load_config("single_room_64")["env"]
    world = single_room.World(env_cfg, 256, "cpu")
    world.reset(threefry.split(words(SEED), 256))
    gen = torch.Generator().manual_seed(1)
    ends = 0
    for _ in range(300):
        _, ended, _ = world.step(torch.randint(0, 4, (256,), generator=gen))
        ends += int(ended.sum())
    assert ends > 0
    assert bool((world.t < 301).all())
