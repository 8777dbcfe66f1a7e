"""The five world families of the port against the JAX package's, bit for
bit, through Env reset, steps, terminations, truncations and auto-resets.

16 envs, 32 rays x 24 px, maps 10x10 (RandomRoom) and 9x9 (Maze), the
default 8x16 room elsewhere, ``max_episode_steps=15``.  After the reset,
envs 0-7 are placed 0.3 world units above a target tile facing it (the goal;
for LockedRoom envs 0-3 face the key) so that goals, collections and key
pickups happen within the 40 steps of numpy-seeded, forward-biased actions.
Every state leaf (the optional ones included), the observation, the reward,
done and every info entry are compared at every step (exact).  Then every
family (MultiPlayerRoom too) resets and steps on the CPU with each option
of the textures / continuous-heading / float64 slice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch.state import LEAVES, OPTIONAL_LEAVES

B = 16
STEPS = 40
BASE = dict(num_rays=32, height_camera_view_pu=24, max_episode_steps=15)

# name -> (game, config, config kwargs, optional leaves the family carries)
CASES = {
    "random_room": ("RandomRoom", "RandomRoomConfig",
                    dict(height_tile_map_tu=10, width_tile_map_tu=10), ()),
    "maze": ("Maze", "MazeConfig",
             dict(height_tile_map_tu=9, width_tile_map_tu=9, obs_type="camera_rgb"), ()),
    "multi_goal_collect_all": ("MultiGoalRoom", "MultiGoalConfig",
                               dict(num_goals=4, obs_type="camera_pal8"),
                               ("goal_words", "goal_tiles")),
    "multi_goal_any": ("MultiGoalRoom", "MultiGoalConfig", dict(collect_all=False),
                       ("goal_words", "goal_tiles")),
    "dynamic_room": ("DynamicRoom", "DynamicRoomConfig", dict(block_period=2),
                     ("blocks",)),
    "locked_room": ("LockedRoom", "LockedRoomConfig",
                    dict(obs_type="camera_pal8", raycast_backend="scan"),
                    ("key_tu", "key_held")),
}


def jax_leaves(state):
    out = {k: np.asarray(getattr(state, k)) for k in LEAVES}
    for k in OPTIONAL_LEAVES:
        if getattr(state, k) is not None:
            out[k] = np.asarray(getattr(state, k))
    return out


def assert_state_equal(got: rt.EnvState, want):
    w = jax_leaves(want)
    g = got.to_numpy()
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def make_envs(name, num_envs=B, **kw):
    game, config, ckw, _ = CASES[name]
    ckw = {**BASE, **ckw, **kw.pop("cfg", {})}
    jenv = rcw.Env(getattr(rcw, game)(getattr(rcw, config)(**ckw)), num_envs=num_envs, **kw)
    env = rt.Env(getattr(rt, game)(getattr(rt, config)(**ckw)), num_envs=num_envs,
                 device="cpu", **kw)
    return jenv, env


def facing_targets(name, js):
    """The JAX state with envs 0-7 placed 0.3 above their target tile,
    heading +i (angle unit 0), and the same state in the port."""
    target = np.asarray(js.goal_tu).copy()
    if name == "locked_room":
        target[:4] = np.asarray(js.key_tu)[:4]
    pos = np.asarray(js.pos_wu).copy()
    dir_au = np.asarray(js.dir_au).copy()
    pos[:8] = target[:8] + np.array([-0.3, 0.5], np.float32)
    dir_au[:8] = 0
    js = js.replace(pos_wu=jnp.asarray(pos), dir_au=jnp.asarray(dir_au))
    return js, rt.EnvState.from_numpy({**jax_leaves(js), "hw": js.hw})


def np_(x):
    return x.detach().cpu().numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_family_env_matches_jax(name):
    jenv, env = make_envs(name)
    js, jobs = jenv.reset(jax.random.PRNGKey(5))
    ts, tobs = env.reset(rt.rng.PRNGKey(5))
    assert_state_equal(ts, js)
    np.testing.assert_array_equal(np_(tobs), np.asarray(jobs))
    assert set(jax_leaves(js)) == set(LEAVES) | set(CASES[name][3])

    js, ts = facing_targets(name, js)
    actions = np.random.default_rng(1).choice(
        4, size=(STEPS, B), p=[0.55, 0.05, 0.2, 0.2]).astype(np.int32)
    actions[:4, :8] = 0
    n_term = n_trunc = n_paid = 0
    for a in actions:
        jr = jenv.step(js, jnp.asarray(a))
        tr = env.step(ts, torch.from_numpy(a))
        assert_state_equal(tr.state, jr.state)
        np.testing.assert_array_equal(np_(tr.obs), np.asarray(jr.obs))
        np.testing.assert_array_equal(np_(tr.reward), np.asarray(jr.reward))
        np.testing.assert_array_equal(np_(tr.done), np.asarray(jr.done))
        assert sorted(tr.info) == sorted(jr.info)
        for k in jr.info:
            np.testing.assert_array_equal(np_(tr.info[k]), np.asarray(jr.info[k]), err_msg=k)
        n_term += int(np.asarray(jr.info["terminated"]).sum())
        n_trunc += int(np.asarray(jr.info["truncated"]).sum())
        n_paid += int((np.asarray(jr.reward) > 0).sum())
        js, ts = jr.state, tr.state
    assert n_trunc > 0 and n_paid > 0
    if name != "multi_goal_collect_all":  # there an episode needs all 4 goals
        assert n_term > 0


def test_family_events_happen():
    """The scripted starts of the parity test reach what each family adds:
    a MultiGoalRoom goal collected mid-episode, a LockedRoom key picked up
    and DynamicRoom blocks that move."""
    seen = {}
    for name in ("multi_goal_collect_all", "locked_room", "dynamic_room"):
        _, env = make_envs(name, num_envs=8)
        ts, _ = env.reset(rt.rng.PRNGKey(5))
        start = ts
        pos = ts.pos_wu.clone()
        target = ts.key_tu if name == "locked_room" else ts.goal_tu
        pos[:] = target.to(torch.float32) + torch.tensor([-0.3, 0.5])
        ts = ts.replace(pos_wu=pos, dir_au=torch.zeros_like(ts.dir_au))
        for _ in range(4):
            ts = env.step(ts, torch.zeros(8, dtype=torch.int32)).state
        seen[name] = ts
        seen[name + "_start"] = start
    mg = seen["multi_goal_collect_all"]
    collected = (mg.goal_tiles[..., 0] == -1).any(dim=-1)
    assert bool(collected.any())
    assert bool((mg.t[collected] == 4).all())  # the episode goes on
    assert bool(seen["locked_room"].key_held.any())
    assert not torch.equal(seen["dynamic_room"].blocks, seen["dynamic_room_start"].blocks)


@pytest.mark.parametrize("name", [n for n in CASES if n != "multi_goal_any"])
def test_family_state_numpy_round_trip(name):
    """A JAX state of each family crosses to the port and back bit for bit,
    optional leaves included, and steps on identically."""
    jenv, env = make_envs(name, num_envs=8)
    js, _ = jenv.reset(jax.random.PRNGKey(7))
    js = jenv.step(js, jnp.zeros(8, jnp.int32)).state
    leaves = jax_leaves(js)
    ts = rt.EnvState.from_numpy({**leaves, "hw": js.hw})
    back = ts.to_numpy()
    assert sorted(back) == sorted(leaves)
    for k in leaves:
        assert back[k].dtype == leaves[k].dtype, k
        np.testing.assert_array_equal(back[k], leaves[k], err_msg=k)
    a = np.random.default_rng(8).integers(0, 4, size=8).astype(np.int32)
    assert_state_equal(env.step(ts, torch.from_numpy(a)).state,
                       jenv.step(js, jnp.asarray(a)).state)


FAMILIES = {
    "single_room": ("SingleRoom", "EnvConfig"),
    "random_room": ("RandomRoom", "RandomRoomConfig"),
    "maze": ("Maze", "MazeConfig"),
    "multi_goal": ("MultiGoalRoom", "MultiGoalConfig"),
    "dynamic_room": ("DynamicRoom", "DynamicRoomConfig"),
    "locked_room": ("LockedRoom", "LockedRoomConfig"),
    "multi_player": ("MultiPlayerRoom", "MultiPlayerConfig"),
}
OPTIONS = {
    "checker": dict(wall_texture="checker"),
    "brick_pal8": dict(wall_texture="brick", obs_type="camera_pal8"),
    "xor": dict(wall_texture="xor", texture_cells=16),
    "continuous": dict(continuous_heading=True, turn_increment_au=0.7),
    "float64": dict(dtype="float64"),
}


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_family_runs_every_option(family, option):
    """Each family constructs and steps on the CPU with each option of the
    last slice (wall textures, continuous headings, float64 worlds), in the
    JAX package's leaf dtypes; a heading turned by 0.7 stays fractional."""
    game, config = FAMILIES[family]
    kw = dict(num_rays=16, height_camera_view_pu=12, **OPTIONS[option])
    if family in ("random_room", "maze"):
        kw.update(height_tile_map_tu=9, width_tile_map_tu=9)
    env = rt.Env(getattr(rt, game)(getattr(rt, config)(**kw)), num_envs=3, device="cpu")
    state, obs = env.reset(rt.rng.PRNGKey(1))
    a = np.full((3,) + env.game.action_shape, 2, np.int32)
    res = env.step(state, torch.from_numpy(a))
    assert tuple(res.obs.shape) == (3,) + env.cfg.obs_shape
    assert res.obs.dtype == env.observation_space.dtype
    f = torch.float64 if option == "float64" else torch.float32
    assert res.state.pos_wu.dtype == f and bool(torch.isfinite(res.state.pos_wu).all())
    if option == "continuous":
        d = np_(res.state.dir_au)
        assert d.dtype == np.float32 and np.all(np.abs(d - np.round(d)) > 1e-3)
    else:
        assert res.state.dir_au.dtype == torch.int32
    if option != "continuous" and "wall_texture" in kw:
        flat = rt.Env(getattr(rt, game)(getattr(rt, config)(
            **{**kw, "wall_texture": "none"})), num_envs=3, device="cpu")
        _, fobs = flat.reset(rt.rng.PRNGKey(1))
        as_i = lambda x: x.view(torch.int32) if x.dtype == torch.uint32 else x  # noqa: E731
        assert not torch.equal(as_i(obs), as_i(fobs))  # the walls are textured
