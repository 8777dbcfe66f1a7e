"""The single-env Game API of the port (``reset_single``, ``step_single``,
``cast_single``, ``observe_from_hits_single``, ``observe_single``,
``top_view_single``, ``camera_view_single``, ``action_names``) against the
JAX package's, and against the numpy oracle and the C++ engine.

64 rays x 64 px, maps of 16x16 or smaller.  The JAX functions are jitted
once per game (a module-scoped cache).  Every state leaf is exact at every
step; frames are exact, but ``depth`` and ``camera_gray`` within 4 ulp
(XLA on the CPU fuses mul+add into FMA) and MultiPlayerRoom's sprite
frames, where the jitted frame differs, exact against the same JAX code run
eagerly.  Each trajectory starts with the player 0.2 above its goal
facing it, so that the first forward moves score, and re-resets from
``state.rng_key`` on ``done``, as a single-env caller does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu.oracle.native import NativeOracleSingleRoom, native_lib
from raycastworlds_tpu.oracle.single_room import OracleSingleRoom
from raycastworlds_tpu_torch.state import LEAVES, OPTIONAL_LEAVES

SMALL = dict(num_rays=64, height_camera_view_pu=64)
STEPS = 16

# name -> (game, config, config kwargs)
FAMILIES = {
    "single_room": ("SingleRoom", "EnvConfig", {}),
    "random_room": ("RandomRoom", "RandomRoomConfig",
                    dict(height_tile_map_tu=12, width_tile_map_tu=12)),
    "maze": ("Maze", "MazeConfig", dict(height_tile_map_tu=11, width_tile_map_tu=11)),
    "multi_goal": ("MultiGoalRoom", "MultiGoalConfig", dict(num_goals=3)),
    "dynamic_room": ("DynamicRoom", "DynamicRoomConfig", dict(block_period=2)),
    "locked_room": ("LockedRoom", "LockedRoomConfig", {}),
    "multi_player": ("MultiPlayerRoom", "MultiPlayerConfig", {}),
}
# (family, obs type, extra config kwargs): every family in camera_u32 and
# in one more observation, every observation type at least once
TRAJECTORIES = [(name, "camera_u32", {}) for name in FAMILIES] + [
    ("single_room", "camera_pal8", {}),
    ("single_room", "depth", dict(raycast_backend="scan")),
    ("random_room", "camera_rgb", {}),
    ("maze", "tile_grid", {}),
    ("multi_goal", "camera_gray", dict(collect_all=False)),
    ("dynamic_room", "depth", {}),
    ("locked_room", "camera_gray_u8", dict(raycast_backend="pallas")),
    ("locked_room", "top_u32", {}),
    ("multi_player", "camera_pal8", dict(num_players=3, player_render="block")),
    ("multi_player", "top_rgb", {}),
]
ULP_OBS = ("depth", "camera_gray")

_GAMES = {}


def games(name, obs_type="camera_u32", **kw):
    """(JAX game, its jitted single functions, port game), built once."""
    key = (name, obs_type, tuple(sorted(kw.items())))
    if key not in _GAMES:
        game, config, ckw = FAMILIES[name]
        ckw = {**SMALL, **ckw, "obs_type": obs_type, **kw}
        jg = getattr(rcw, game)(getattr(rcw, config)(**ckw))
        fns = {f: jax.jit(getattr(jg, f)) for f in (
            "reset_single", "step_single", "observe_single", "top_view_single",
            "camera_view_single")}
        if name != "multi_player":  # JAX casts one player only
            fns["cast_single"] = jax.jit(jg.cast_single)
            fns["observe_from_hits_single"] = jax.jit(jg.observe_from_hits_single)
        _GAMES[key] = (jg, fns, getattr(rt, game)(getattr(rt, config)(**ckw)))
    return _GAMES[key]


def np_(x):
    x = x.detach().cpu()
    return x.view(torch.int32).numpy().view(np.uint32) if x.dtype == torch.uint32 else x.numpy()


def jax_leaves(state):
    out = {k: np.asarray(getattr(state, k)) for k in LEAVES}
    for k in OPTIONAL_LEAVES:
        if getattr(state, k) is not None:
            out[k] = np.asarray(getattr(state, k))
    return out


def assert_state_equal(got: rt.EnvState, want, msg=""):
    w = jax_leaves(want)
    g = got.to_numpy()
    assert sorted(g) == sorted(w), msg
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, (msg, k)
        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{msg} {k}")


def assert_frame(got, want, obs_type, eager=None, msg=""):
    """``got`` (torch) against the jitted JAX frame ``want``: exact, within 4
    ulp for depth and camera_gray, or, where they differ and ``eager`` is
    given, exact against ``eager()`` (the JAX function run eagerly)."""
    g, w = np_(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, msg
    if obs_type in ULP_OBS:
        np.testing.assert_array_max_ulp(g, w, maxulp=4)
    elif eager is not None and not np.array_equal(g, w):
        np.testing.assert_array_equal(g, np.asarray(eager()), err_msg=msg)
    else:
        np.testing.assert_array_equal(g, w, err_msg=msg)


def np_tensor(x):
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def port_key(key):
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def facing_goal(js):
    """The JAX state with the player (player 0) 0.2 above its goal tile,
    heading +i, and the same state in the port."""
    pos = np.asarray(js.pos_wu).copy()
    dir_au = np.asarray(js.dir_au).copy()
    at = np.asarray(js.goal_tu) + np.array([-0.2, 0.5], np.float32)
    if pos.ndim == 2:
        pos[0], dir_au[0] = at, 0
    else:
        pos, dir_au = at.astype(np.float32), np.int32(0)
    js = js.replace(pos_wu=jnp.asarray(pos), dir_au=jnp.asarray(dir_au))
    return js, rt.EnvState.from_numpy({**jax_leaves(js), "hw": js.hw})


@pytest.mark.parametrize("name,obs_type,kw", TRAJECTORIES,
                         ids=[f"{n}-{o}" + ("-" + "-".join(map(str, k.values())) if k else "")
                              for n, o, k in TRAJECTORIES])
def test_single_trajectory_matches_jax(name, obs_type, kw):
    """reset_single, STEPS step_single/observe_single with numpy-seeded
    actions ([P] for MultiPlayerRoom), re-reset from rng_key on done."""
    jg, f, game = games(name, obs_type, **kw)
    key = jax.random.PRNGKey(3)
    js, ts = f["reset_single"](key), game.reset_single(port_key(key), "cpu")
    assert_state_equal(ts, js, "reset")
    js, ts = facing_goal(js)
    shape = game.action_shape
    actions = np.random.default_rng(1).choice(
        4, size=(STEPS,) + shape, p=[0.55, 0.05, 0.2, 0.2]).astype(np.int32)
    actions[:3] = 0
    dones = paid = 0
    for t, a in enumerate(actions):
        js = f["step_single"](js, jnp.asarray(a))
        ts = game.step_single(ts, torch.from_numpy(a) if shape else int(a))
        assert_state_equal(ts, js, f"step {t}")
        paid += int(np.any(np.asarray(js.reward) > 0))
        if bool(js.done):
            dones += 1
            js, ts = f["reset_single"](js.rng_key), game.reset_single(ts.rng_key, ts.device)
            assert_state_equal(ts, js, f"re-reset {t}")
        eager = (lambda: jg.observe_single(js)) if name == "multi_player" else None
        assert_frame(game.observe_single(ts), f["observe_single"](js), obs_type, eager,
                     f"obs {t}")
    assert paid > 0
    if not (name == "multi_goal" and game.cfg.collect_all):
        assert dones > 0
    assert game.action_names() == jg.action_names() == rt.ACTION_NAMES


@pytest.mark.parametrize("name", list(FAMILIES))
def test_single_views_match_jax(name):
    """cast_single, observe_from_hits_single (the single-player families:
    the JAX package casts one player only), top_view_single and
    camera_view_single at one state after a reset and three steps."""
    jg, f, game = games(name, "camera_u32")
    key = jax.random.PRNGKey(11)
    js, ts = f["reset_single"](key), game.reset_single(port_key(key), "cpu")
    for act in (2, 2, 0):
        act = np.full(game.action_shape, act, np.int32)
        js = f["step_single"](js, jnp.asarray(act))
        ts = game.step_single(ts, torch.from_numpy(act))
    assert_state_equal(ts, js)
    eager = (lambda fn: (lambda: fn(js))) if name == "multi_player" else (lambda fn: None)
    assert_frame(game.top_view_single(ts), f["top_view_single"](js), "top_u32",
                 eager(jg.top_view_single), "top")
    assert_frame(game.camera_view_single(ts), f["camera_view_single"](js), "camera_u32",
                 eager(jg.camera_view_single), "camera")
    if name == "multi_player":
        return
    jh, th = f["cast_single"](js), game.cast_single(ts)
    for field in ("ray_dirs", "hit_tu", "hit_dim", "dist_wu"):
        g, w = np_(getattr(th, field)), np.asarray(getattr(jh, field))
        assert g.dtype == w.dtype and g.shape == w.shape == (64,) + w.shape[1:], field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert_frame(game.observe_from_hits_single(ts, th),
                 f["observe_from_hits_single"](js, jh), "camera_u32", msg="from hits")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_single_is_row_of_batch(name):
    """The port's reset_single(keys[k]) and step_single are row k of
    reset_batch/step_batch over 8 envs with the same keys and actions."""
    _, _, game = games(name, "camera_u32")
    keys = rt.rng.split(rt.rng.PRNGKey(4), 8)
    k = 5
    batch, single = game.reset_batch(keys), game.reset_single(keys[k], "cpu")
    actions = np.random.default_rng(2).integers(0, 4, size=(6, 8) + game.action_shape)
    actions = actions.astype(np.int32)
    for t, a in enumerate(actions):
        row = batch.index(torch.tensor([k])).unbatch()
        for leaf, v in single.leaves().items():
            w = row.leaves()[leaf]
            assert v.dtype == w.dtype and torch.equal(v, w), (t, leaf)
        assert torch.equal(np_tensor(game.observe_single(single)),
                           np_tensor(game.observe_batch(batch)[k])), t
        batch = game.step_batch(batch, torch.from_numpy(a))
        single = game.step_single(single, torch.as_tensor(a[k]))


def test_single_state_helpers():
    """batch1/unbatch: a leading env axis of one and back, optional leaves
    included; the 0-dim leaves keep the batch path's dtypes."""
    _, _, game = games("locked_room", "camera_u32")
    s = game.reset_single(rt.rng.PRNGKey(0), "cpu")
    assert s.dir_au.shape == () and s.dir_au.dtype == torch.int32
    assert s.reward.shape == () and s.reward.dtype == torch.float32
    assert s.done.shape == () and s.done.dtype == torch.bool
    assert s.rng_key.shape == (2,) and s.rng_key.dtype == torch.int64
    assert s.key_held.shape == () and s.pos_wu.shape == (2,)
    b = s.batch1()
    assert all(v.shape[0] == 1 for v in b.leaves().values())
    back = b.unbatch()
    assert sorted(back.leaves()) == sorted(s.leaves())
    assert all(torch.equal(back.leaves()[k], v) for k, v in s.leaves().items())
    s2 = game.step_single(s, 2)
    assert s2.dir_au.dtype == torch.int32 and s2.reward.dtype == torch.float32
    assert s2.done.dtype == torch.bool and int(s2.t) == 1


def test_reset_single_device_rule():
    """reset_single runs on the CUDA device unless given a device, as Env:
    without a card and without device="cpu" it raises, whatever device its
    key lies on; given a device, the state lies there and the other single
    methods follow it."""
    game = games("single_room", "camera_u32")[2]
    if torch.cuda.is_available():
        assert game.reset_single(rt.rng.PRNGKey(0)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="reset_single runs on the CUDA device"):
            game.reset_single(rt.rng.PRNGKey(0))
    s = game.reset_single(rt.rng.PRNGKey(0), "cpu")
    assert all(v.device.type == "cpu" for v in s.leaves().values())
    assert game.step_single(s, 0).device.type == "cpu"
    assert game.reset_single(s.rng_key, s.device).device.type == "cpu"


def _drive_against(oracle_cls, backend):
    """The port's SingleRoom over 120 steps against ``oracle_cls``:
    positions, headings, rewards and dones exact and camera views
    identical at every step.  The first episode starts 0.2 above the goal
    facing it and walks in, so that later episodes are re-reset from the
    shared key."""
    cfg = rcw.config.replace(rcw.EnvConfig(**SMALL), raycast_backend=backend)
    game = rt.SingleRoom(rt.EnvConfig(**SMALL, raycast_backend=backend))
    oracle = oracle_cls(cfg)
    key = jax.random.PRNGKey(17)
    state = game.reset_single(port_key(key), "cpu")
    oracle.reset(key)
    at = np.asarray(oracle.goal_tu, np.float32) + np.array([-0.2, 0.5], np.float32)
    oracle.pos_wu, oracle.dir_au = at, 0
    state = state.replace(pos_wu=torch.from_numpy(at),
                          dir_au=torch.zeros((), dtype=torch.int32))
    rng = np.random.RandomState(1)
    resets = 0
    for t in range(120):
        assert np_(state.pos_wu).tolist() == oracle.pos_wu.tolist(), t
        assert int(state.dir_au) == oracle.dir_au, t
        assert float(state.reward) == float(oracle.reward), t
        assert bool(state.done) == oracle.done, t
        np.testing.assert_array_equal(np_(game.observe_single(state)),
                                      oracle.camera_view(), err_msg=str(t))
        if bool(state.done):
            resets += 1
            k = jnp.asarray(np_(state.rng_key).astype(np.uint32))
            state = game.reset_single(state.rng_key, state.device)
            oracle.reset(k)
        else:
            a = 0 if t < 3 else int(rng.choice(4, p=[0.55, 0.05, 0.2, 0.2]))
            state = game.step_single(state, a)
            oracle.step(a)
    assert resets > 0


@pytest.mark.parametrize("backend", ["scan", "crossing"])
def test_single_room_matches_oracles(backend):
    """Against OracleSingleRoom, the numpy oracle."""
    _drive_against(OracleSingleRoom, backend)


@pytest.mark.skipif(native_lib() is None, reason="librefengine.so not built")
@pytest.mark.parametrize("backend", ["scan", "crossing"])
def test_single_room_matches_native_oracle(backend):
    """Against NativeOracleSingleRoom, the C++ engine in native/."""
    _drive_against(NativeOracleSingleRoom, backend)
