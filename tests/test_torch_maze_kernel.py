"""Maze's reset kernel (``csrc/maze_reset.cu``) and its dispatch in
``raycastworlds_tpu_torch.models.maze``.

* On the CPU: the wrapper, launching an emulation of the kernel
  (``maze_kernel_emulation``: numpy over the launch's raw pointers), equals
  ``Maze.reset_batch_plain`` leaf for leaf, in one launch a reset, on
  5x5, 17x17, 9x21, 21x9 and 31x31 maps with 0, 1, 3 and 8 rooms of
  half-extent up to 1, 2 and 4, in float32 and float64, with discrete and
  continuous headings, and with keys laid out in other strides; a budgeted
  Maze ``Env`` through the emulation equals its plain run, state for
  state; a CPU key never reaches ``cuda_build``; a map over
  ``KERNEL_MAX_WORDS`` and keys of another type or shape raise; an empty
  batch launches nothing.
* On a CUDA card, the kernel against the plain path on the card, bit for
  bit, over the same grid at 1, 512 and 32768 keys, one launch a reset and
  no other, and a budgeted ``Env`` at ``maze_17x17``'s configuration (32768
  envs, a budget of 512) stepped on the card equal to the CPU run:
  ``python -m pytest tests/test_torch_maze_kernel.py -m cuda --noconftest``.

This file imports no JAX: the plain path is the reference (it equals the
JAX package's Maze, ``tests/test_torch_families.py``).
"""

import itertools
import json
import os
import types

import numpy as np
import pytest
import torch

import maze_kernel_emulation as emulation
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch import cuda_build
from raycastworlds_tpu_torch.models import maze
from raycastworlds_tpu_torch.ops import bitmap
from raycastworlds_tpu_torch.state import LEAVES
from raycastworlds_tpu_torch.utils import profiling

CELL_CONFIG = os.path.join(os.path.dirname(__file__), os.pardir, "benchmark", "configs",
                           "maze_17x17.json")

# -- the cases -----------------------------------------------------------

MAPS = [(5, 5), (17, 17), (9, 21), (21, 9), (31, 31)]
CASES = list(itertools.product(MAPS, [0, 1, 3, 8], [1, 2, 4], ["float32", "float64"],
                               [False, True]))


def _id(case):
    (h, w), rooms, half, dtype, continuous = case
    return f"{h}x{w}-rooms{rooms}-half{half}-{dtype}-{'cont' if continuous else 'disc'}"


def _game(case, **kw):
    (h, w), rooms, half, dtype, continuous = case
    return rt.Maze(rt.MazeConfig(height_tile_map_tu=h, width_tile_map_tu=w, num_rooms=rooms,
                                 room_max_half_tu=half, dtype=dtype,
                                 continuous_heading=continuous, num_rays=8,
                                 height_camera_view_pu=8, **kw))


def _keys(b, seed=0):
    """int64 keys [b, 2] with uint32 words, many with the top bit set, the
    first all ones."""
    words = np.random.default_rng(seed).integers(0, 2**32, size=(b, 2), dtype=np.int64)
    words[0] = 2**32 - 1
    return torch.from_numpy(words)


def _assert_same_state(got, want):
    assert got.hw == want.hw
    for leaf in LEAVES:
        a, b = getattr(got, leaf), getattr(want, leaf)
        assert a.dtype == b.dtype and a.shape == b.shape, leaf
        assert a.device == b.device, leaf
        assert torch.equal(a, b), leaf


# -- the wrapper on the CPU, launching an emulation of the kernel --------

def _through_emulation(monkeypatch, fn):
    """``fn()`` with the reset dispatched as for a CUDA key, the kernel's
    launch going to the emulation; (result, launches made)."""
    launches = []

    def launch(entry, device, *args, what):
        assert entry is emulation.rcw_maze_reset and what == "maze reset"
        assert device.type == "cpu"
        launches.append(args)
        entry(*args)

    with monkeypatch.context() as m:
        m.setattr(maze, "_uses_kernel", lambda keys: True)
        m.setattr(cuda_build, "load",
                  lambda: types.SimpleNamespace(rcw_maze_reset=emulation.rcw_maze_reset))
        m.setattr(cuda_build, "launch", launch)
        return fn(), launches


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_wrapper_equals_plain_path(monkeypatch, case):
    """The emulated kernel's reset is the plain path's, leaf for leaf, in
    one launch, on every map, room count, room size, float dtype and
    heading kind."""
    game, keys = _game(case), _keys(16, seed=len(_id(case)))
    want = game.reset_batch_plain(keys)
    got, launches = _through_emulation(monkeypatch, lambda: game.reset_batch(keys))
    assert len(launches) == 1
    _assert_same_state(got, want)


def _laid_out(keys, layout):
    """The same keys in another memory layout: every third row of a wider
    tensor, or the two words in separate planes."""
    if layout == "strided":
        wide = torch.zeros((keys.shape[0], 3, 2), dtype=keys.dtype)
        wide[:, 1] = keys
        return wide[:, 1]
    return keys.t().contiguous().t()


@pytest.mark.parametrize("layout", ["strided", "words_apart"])
def test_wrapper_reads_keys_through_their_strides(monkeypatch, layout):
    game, keys = _game(((17, 17), 3, 2, "float32", False)), _keys(9, seed=4)
    laid = _laid_out(keys, layout)
    assert not laid.is_contiguous() and torch.equal(laid, keys)
    got, launches = _through_emulation(monkeypatch, lambda: game.reset_batch(laid))
    assert len(launches) == 1
    _assert_same_state(got, game.reset_batch_plain(keys))


def test_cases_are_not_trivial():
    """The rooms open tiles the carve left as walls, the goal and the spawn
    differ, and the headings spread over the directions."""
    keys = _keys(64, seed=1)
    carved = _game(((17, 17), 0, 2, "float32", False)).reset_batch_plain(keys)
    roomy = _game(((17, 17), 8, 4, "float32", False)).reset_batch_plain(keys)
    walls = lambda s: bitmap.unpack_bits(s.wall_words, (17, 17))  # noqa: E731
    assert (walls(carved) & ~walls(roomy)).any(dim=(1, 2)).all()
    assert not (~walls(carved) & walls(roomy)).any()
    assert (roomy.goal_tu != roomy.pos_wu.floor().to(torch.int32)).any(dim=1).all()
    assert len(torch.unique(roomy.dir_au)) > 32


def test_maze_env_through_emulation(monkeypatch):
    """A budgeted Maze ``Env`` (9 x 11 maps, 16 envs, budget 4, episodes cut
    at 3 steps so the budget fills) with every reset through the emulated
    kernel is its plain run, state for state."""
    cfg = rt.MazeConfig(height_tile_map_tu=9, width_tile_map_tu=11, num_rays=8,
                        height_camera_view_pu=8, max_episode_steps=3)

    def run():
        env = rt.Env(rt.Maze(cfg), num_envs=16, device="cpu", reset_budget=4)
        state, _ = env.reset(rt.rng.PRNGKey(7))
        states = [state.to_numpy()]
        for t in range(6):
            state = env.step(state, env.sample_action(rt.rng.PRNGKey(50 + t))).state
            states.append(state.to_numpy())
        return states

    want = run()
    got, launches = _through_emulation(monkeypatch, run)
    assert len(launches) == 7  # the first reset and one budgeted reset a step
    assert want[-1]["pending_reset"].any()
    for t, (a, b) in enumerate(zip(want, got)):
        for leaf in a:
            np.testing.assert_array_equal(a[leaf], b[leaf], err_msg=f"step {t} {leaf}")


def test_python_limit_is_the_kernels():
    assert maze.KERNEL_MAX_WORDS == emulation.constant("kMaxWords")


@pytest.mark.parametrize("hw", [(361, 363), (5, 26213), (26213, 5)])
def test_map_at_the_limit_launches(monkeypatch, hw):
    """Maps of KERNEL_MAX_WORDS words go to the kernel."""
    game = rt.Maze(rt.MazeConfig(height_tile_map_tu=hw[0], width_tile_map_tu=hw[1]))
    assert -(-hw[0] * hw[1] // 32) == maze.KERNEL_MAX_WORDS
    keys = _keys(2, seed=2)
    got, launches = _through_emulation(monkeypatch, lambda: game.reset_batch(keys))
    assert len(launches) == 1
    _assert_same_state(got, game.reset_batch_plain(keys))


@pytest.mark.parametrize("hw", [(363, 363), (5, 26215), (26215, 5)])
def test_map_over_the_limit_raises(monkeypatch, hw):
    game = rt.Maze(rt.MazeConfig(height_tile_map_tu=hw[0], width_tile_map_tu=hw[1]))
    with pytest.raises(ValueError, match="KERNEL_MAX_WORDS"):
        _through_emulation(monkeypatch, lambda: game.reset_batch(_keys(1)))


def _bad_keys():
    keys = _keys(5)
    return {
        "int32": keys.to(torch.int32),
        "float": keys.to(torch.float64),
        "1d": keys[:, 0].contiguous(),
        "3_words": torch.cat([keys, keys[:, :1]], dim=1),
        "3d": keys[None],
    }


@pytest.mark.parametrize("name", list(_bad_keys()))
def test_wrapper_refuses_other_keys(monkeypatch, name):
    game = _game(((9, 9), 3, 2, "float32", False))
    with pytest.raises(ValueError, match="keys must be int64"):
        _through_emulation(monkeypatch, lambda: game.reset_batch(_bad_keys()[name]))


def test_wrapper_refuses_a_room_bound_outside_int32(monkeypatch):
    game = rt.Maze(rt.MazeConfig(room_max_half_tu=2**31 - 1))
    with pytest.raises(ValueError, match="room_max_half_tu"):
        _through_emulation(monkeypatch, lambda: game.reset_batch(_keys(2)))


def test_empty_batch_launches_nothing(monkeypatch):
    game = _game(((17, 17), 3, 2, "float64", True))
    got, launches = _through_emulation(
        monkeypatch, lambda: game.reset_batch(torch.zeros(0, 2, dtype=torch.int64)))
    assert launches == []
    one = game.reset_batch_plain(_keys(1))  # the plain path takes no empty batch
    for leaf in LEAVES:
        a, b = getattr(got, leaf), getattr(one, leaf)
        assert a.dtype == b.dtype and a.shape == (0,) + b.shape[1:], leaf


# -- a CPU key takes the plain path -------------------------------------

def _never(*args, **kwargs):
    raise AssertionError("a CPU key reached cuda_build")


@pytest.mark.parametrize("hw", MAPS)
def test_cpu_key_never_reaches_cuda_build(monkeypatch, hw):
    monkeypatch.setattr(cuda_build, "load", _never)
    monkeypatch.setattr(cuda_build, "launch", _never)
    game, keys = _game((hw, 3, 2, "float32", False)), _keys(8, seed=3)
    before = profiling.total("kernel_launches.maze_reset")
    got = game.reset_batch(keys)
    assert got.device.type == "cpu"
    _assert_same_state(got, game.reset_batch_plain(keys))
    assert profiling.total("kernel_launches.maze_reset") == before


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _launches(kernel="maze_reset"):
    return profiling.total(f"kernel_launches.{kernel}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_cuda_kernel_matches_plain(cuda_device, case):
    """One launch a reset and no threefry launch; every leaf equal to the
    plain path's on the card, at 1, 512 and 32768 keys, and to the CPU's at
    1 and 512."""
    game = _game(case)
    for b in (1, 512, 32768):
        keys = _keys(b, seed=b + len(_id(case))).to(cuda_device)
        before, hashes = _launches(), _launches("threefry")
        got = game.reset_batch(keys)
        torch.cuda.synchronize()
        assert _launches() == before + 1 and _launches("threefry") == hashes
        _assert_same_state(got, game.reset_batch_plain(keys))
        if b <= 512:
            _assert_same_state(got.to("cpu"), game.reset_batch_plain(keys.cpu()))


def _cell_config(**kw):
    with open(CELL_CONFIG) as f:
        cell = json.load(f)
    return rt.MazeConfig(**{**cell["env"], **kw}), cell["reset_budget"]


@pytest.mark.cuda
@pytest.mark.parametrize("max_episode_steps", [0, 4])
def test_cuda_maze_env_matches_cpu(cuda_device, max_episode_steps):
    """``maze_17x17``'s configuration (17x17, 3 rooms, 64 rays x 64 px
    camera_u32) at its 32768 envs and budget of 512, stepped 12 times on
    the card with sampled actions: every state and the last frames equal
    the CPU run's, one kernel launch a reset.  Without an episode limit, as
    the cell runs, and with episodes cut at 4 steps, so that every env ends
    at once and the budget freezes most of them."""
    cfg, budget = _cell_config(max_episode_steps=max_episode_steps)
    runs = {}
    for dev in ("cpu", cuda_device):
        env = rt.Env(rt.Maze(cfg), num_envs=32768, device=dev, reset_budget=budget)
        before = _launches()
        state, _ = env.reset(rt.rng.PRNGKey(5))
        key = rt.rng.PRNGKey(6, dev)
        states = [state.to_numpy()]
        for t in range(12):
            res = env.step(state, env.sample_action(rt.rng.fold_in(key, t)))
            state = res.state
            states.append(state.to_numpy())
        runs[str(dev)] = (states, res.obs.cpu(), _launches() - before)
    (cpu_states, cpu_obs, cpu_launches), (states, obs, launches) = runs.values()
    assert cpu_launches == 0 and launches == 13
    if max_episode_steps:
        assert cpu_states[-1]["pending_reset"].sum() > 16384
    for t, (a, b) in enumerate(zip(cpu_states, states)):
        for leaf in a:
            np.testing.assert_array_equal(a[leaf], b[leaf], err_msg=f"step {t} {leaf}")
    assert torch.equal(obs, cpu_obs)
