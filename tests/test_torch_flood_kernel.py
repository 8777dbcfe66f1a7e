"""The reachability fill's CUDA kernel (``csrc/flood_fill.cu``) and its
dispatch in ``raycastworlds_tpu_torch.ops.flood``.

* On the CPU: the wrapper, launching an emulation of the kernel (numpy over
  the launch's raw pointers: the maps packed into rows of 32-bit words, one
  dilation a round with carries between a row's words, a block's envs
  stopping together at the first round that changes no word), equals the
  plain ``flood_fill`` on random and serpentine maps of 5x5 to 64x64 tiles
  (one and two words a row, masked tail bits), at wall densities 0, 0.2 and
  0.6, with seeds on walled-in goals, on edge tiles, on walls and outside
  the map, after 1, 5 and the bound's dilations, in one launch a fill; a
  RandomRoom ``Env`` through the emulation equals its plain run; a CPU map
  never reaches ``cuda_build``; a map over ``KERNEL_MAX_WORDS`` and inputs
  of another type, shape or layout raise.
* On a CUDA card, the kernel against the plain path on the card and on the
  CPU, bit for bit, on the same cases and on [8192, 16, 16] at density
  0.2, one launch a fill, and an 8192-env RandomRoom ``Env`` with a reset
  budget of 256 stepped 64 times equal to the CPU run:
  ``python -m pytest tests/test_torch_flood_kernel.py -m cuda --noconftest``.

This file imports no JAX: the plain path is the reference (it equals the
JAX package's fill, ``tests/test_torch_sampling_flood.py``).
"""

import ctypes
import os
import re
import types

import numpy as np
import pytest
import torch

import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch import cuda_build
from raycastworlds_tpu_torch.ops import flood
from raycastworlds_tpu_torch.utils import profiling

SOURCE = os.path.join(os.path.dirname(cuda_build.__file__), "csrc", "flood_fill.cu")


def _constant(name):
    with open(SOURCE) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


THREADS = _constant("kThreads")


# -- the cases -----------------------------------------------------------

SHAPES = [(5, 5), (7, 9), (16, 16), (17, 17), (33, 40), (64, 64)]
DENSITIES = [0.0, 0.2, 0.6]
ITERS = [1, 5, None]  # None: the bound, H*W//2 + 2


def _serpentine(h, w):
    """A corridor that snakes from row 0 down: every other row walled but
    for one gap at alternating ends, so the path is about H*W/2 long."""
    m = np.ones((h, w), bool)
    for i in range(1, h, 2):
        m[i] = False
        m[i, w - 1 if (i // 2) % 2 == 0 else 0] = True
    return m


def _case(h, w, density, seed=0):
    """(passable bool[12, H, W], seeds int32[12, 2]): random maps, the odd
    envs inside a border ring of walls, and one env of each seed kind:
    random tiles (0-3, on walls too), a walled-in goal (4), the four
    corners (5-8), the last tile of a row's first word (9), a wall (10) and
    outside the map (11); density "serpentine" is ``_serpentine`` for every
    env, seeded at random tiles."""
    rng = np.random.default_rng(seed * 1000 + h * 100 + w)
    b = 12
    if density == "serpentine":
        passable = np.broadcast_to(_serpentine(h, w), (b, h, w)).copy()
    else:
        passable = rng.random((b, h, w)) >= density
        passable[1::2, [0, -1], :] = False
        passable[1::2, :, [0, -1]] = False
    seeds = np.stack([rng.integers(0, h, b), rng.integers(0, w, b)], -1)
    if density != "serpentine":
        i, j = rng.integers(1, h - 1), rng.integers(1, w - 1)
        passable[4, i - 1:i + 2, j - 1:j + 2] = False
        passable[4, i, j] = True
        seeds[4] = (i, j)
        for e, tile in zip(range(5, 10), [(0, 0), (h - 1, w - 1), (0, w - 1), (h - 1, 0),
                                          (h // 2, min(31, w - 1))]):
            passable[e, tile[0], tile[1]] = True
            seeds[e] = tile
        passable[10, seeds[10][0], seeds[10][1]] = False
        seeds[11] = (h, -1)
    return torch.from_numpy(passable), torch.from_numpy(seeds.astype(np.int32))


CASES = [(hw, d, it) for hw in SHAPES for d in DENSITIES for it in ITERS] + [
    (hw, "serpentine", it) for hw in ((17, 17), (64, 64)) for it in (5, None)]


def _id(case):
    (h, w), density, iters = case
    return f"{h}x{w}-{density}-{'bound' if iters is None else iters}"


# -- the wrapper on the CPU, launching an emulation of the kernel --------

def _array(ctype, address, n):
    return np.ctypeslib.as_array((ctype * n).from_address(address))


def _emulated_kernel(passable_ptr, seed_ptr, out_ptr, b, h, w, num_iters):
    """``rcw_flood_fill`` on host memory: the C entry's arguments (without
    the stream), read, computed and written as the kernel does."""
    nw = -(-w // 32)
    n = h * nw
    assert b >= 1 and n <= _constant("kMaxWords") and num_iters >= 0
    tiles = _array(ctypes.c_uint8, passable_ptr, b * h * w).reshape(b, h, w)
    seed = _array(ctypes.c_int32, seed_ptr, 2 * b).reshape(b, 2)
    bits = np.zeros((b, h, nw * 32), np.uint32)
    bits[..., :w] = tiles != 0
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    pas = np.bitwise_or.reduce(bits.reshape(b, h, nw, 32) * weights, axis=-1)
    cur = np.zeros_like(pas)
    for e, (si, sj) in enumerate(seed):
        if 0 <= si < h and 0 <= sj < w:
            cur[e, si, sj // 32] = pas[e, si, sj // 32] & (np.uint32(1) << np.uint32(sj % 32))
    one, top = np.uint32(1), np.uint32(31)
    per_block = 1 if n >= THREADS else THREADS // n
    for b0 in range(0, b, per_block):
        r, p = cur[b0:b0 + per_block], pas[b0:b0 + per_block]
        for _ in range(num_iters):
            v = r | (r << one) | (r >> one)
            v[..., 1:] |= r[..., :-1] >> top
            v[..., :-1] |= r[..., 1:] << top
            v[:, 1:] |= r[:, :-1]
            v[:, :-1] |= r[:, 1:]
            v &= p
            changed = (v != r).any()
            r = v
            if not changed:
                break
        cur[b0:b0 + per_block] = r
    reached = (cur[..., None] >> np.arange(32, dtype=np.uint32)) & one
    _array(ctypes.c_uint8, out_ptr, b * h * w)[:] = (
        reached.reshape(b, h, nw * 32)[..., :w].reshape(-1))


def _through_emulation(monkeypatch, fn):
    """``fn()`` with the fill dispatched as for a CUDA map, the kernel's
    launch going to the emulation; (result, launches made)."""
    launches = []

    def launch(entry, device, *args, what):
        assert entry is _emulated_kernel and what == "flood fill" and device.type == "cpu"
        launches.append(args)
        entry(*args)

    with monkeypatch.context() as m:
        m.setattr(flood, "_uses_kernel", lambda passable: True)
        m.setattr(cuda_build, "load",
                  lambda: types.SimpleNamespace(rcw_flood_fill=_emulated_kernel))
        m.setattr(cuda_build, "launch", launch)
        return fn(), launches


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_wrapper_equals_plain_path(monkeypatch, case):
    """The emulated kernel's fill is the plain path's, bit for bit, in one
    launch, on every shape, density, seed kind and trip count."""
    (h, w), density, iters = case
    passable, seeds = _case(h, w, density)
    want = flood.flood_fill(passable, seeds, iters)
    got, launches = _through_emulation(monkeypatch,
                                       lambda: flood.flood_fill(passable, seeds, iters))
    assert len(launches) == 1
    assert got.dtype == torch.bool and got.shape == want.shape
    assert torch.equal(got, want)


def test_cases_reach_far():
    """The cases are not trivial: at the bound the fills reach whole rooms,
    the walled-in goal only itself, the wall seed and the outside one
    nothing; the serpentine needs more than 5 dilations."""
    passable, seeds = _case(16, 16, 0.0)
    reach = flood.flood_fill(passable, seeds)
    assert torch.equal(reach[0], passable[0]) and int(reach[4].sum()) == 1
    assert not reach[10].any() and not reach[11].any()
    passable, seeds = _case(17, 17, "serpentine")
    assert not torch.equal(flood.flood_fill(passable, seeds, 5),
                           flood.flood_fill(passable, seeds))


def test_random_room_through_emulation(monkeypatch):
    """A RandomRoom ``Env`` (9 x 11 maps, 16 envs, budget 4, episodes cut
    at 3 steps) with every fill through the emulated kernel is its plain
    run, state for state: the generator's inputs are what the wrapper
    takes."""
    cfg = rt.RandomRoomConfig(height_tile_map_tu=9, width_tile_map_tu=11, num_rays=8,
                              height_camera_view_pu=8, obs_type="camera_rgb",
                              max_episode_steps=3, wall_density=0.3)

    def run():
        env = rt.Env(rt.RandomRoom(cfg), num_envs=16, device="cpu", reset_budget=4)
        state, _ = env.reset(rt.rng.PRNGKey(7))
        states = [state.to_numpy()]
        for t in range(6):
            state = env.step(state, env.sample_action(rt.rng.PRNGKey(50 + t))).state
            states.append(state.to_numpy())
        return states

    want = run()
    got, launches = _through_emulation(monkeypatch, run)
    assert len(launches) == 7  # the first reset and one budgeted reset a step
    for t, (a, b) in enumerate(zip(want, got)):
        for leaf in a:
            np.testing.assert_array_equal(a[leaf], b[leaf], err_msg=f"step {t} {leaf}")


def test_python_limit_is_the_kernels():
    assert flood.KERNEL_MAX_WORDS == _constant("kMaxWords")


@pytest.mark.parametrize("hw", [(256, 512), (4096, 32), (256, 256)])
def test_map_at_the_limit_launches(monkeypatch, hw):
    """Maps of KERNEL_MAX_WORDS words (and 256 x 256, every map the
    kernel must take) go to the kernel."""
    passable, seeds = _case(*hw, 0.2)
    passable, seeds = passable[:2].contiguous(), seeds[:2].contiguous()
    got, launches = _through_emulation(monkeypatch,
                                       lambda: flood.flood_fill(passable, seeds, 3))
    assert len(launches) == 1 and torch.equal(got, flood.flood_fill(passable, seeds, 3))


@pytest.mark.parametrize("hw", [(257, 512), (4097, 5), (64, 2049), (1, 131073)])
def test_map_over_the_limit_raises(monkeypatch, hw):
    passable = torch.ones((1,) + hw, dtype=torch.bool)
    seeds = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="KERNEL_MAX_WORDS"):
        _through_emulation(monkeypatch, lambda: flood.flood_fill(passable, seeds))


def _bad_inputs():
    passable, seeds = _case(7, 9, 0.2)
    return {
        "uint8_map": (passable.to(torch.uint8), seeds),
        "strided_map": (passable.transpose(1, 2), seeds),
        "int64_seeds": (passable, seeds.long()),
        "strided_seeds": (passable, seeds.t().contiguous().t()),
        "short_seeds": (passable, seeds[:5]),
        "2d_map": (passable[0], seeds[:1]),
    }


@pytest.mark.parametrize("name", list(_bad_inputs()))
def test_wrapper_refuses_other_inputs(monkeypatch, name):
    passable, seeds = _bad_inputs()[name]
    with pytest.raises(ValueError):
        _through_emulation(monkeypatch, lambda: flood._flood_fill_kernel(passable, seeds, 3))


def test_empty_batch_launches_nothing(monkeypatch):
    passable = torch.zeros(0, 7, 9, dtype=torch.bool)
    got, launches = _through_emulation(
        monkeypatch, lambda: flood.flood_fill(passable, torch.zeros(0, 2, dtype=torch.int32)))
    assert launches == [] and tuple(got.shape) == (0, 7, 9)


# -- a CPU map takes the plain path -------------------------------------

def _never(*args, **kwargs):
    raise AssertionError("a CPU map reached cuda_build")


@pytest.mark.parametrize("hw", SHAPES)
def test_cpu_map_never_reaches_cuda_build(monkeypatch, hw):
    monkeypatch.setattr(cuda_build, "load", _never)
    monkeypatch.setattr(cuda_build, "launch", _never)
    passable, seeds = _case(*hw, 0.2)
    before = profiling.total("kernel_launches.flood_fill")
    out = flood.flood_fill(passable, seeds)
    assert out.device.type == "cpu"
    assert torch.equal(out, flood.flood_fill_plain(passable, seeds, hw[0] * hw[1] // 2 + 2))
    assert profiling.total("kernel_launches.flood_fill") == before


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _launches():
    return profiling.total("kernel_launches.flood_fill")


def _card_matches(passable, seeds, iters, device):
    want = flood.flood_fill(passable, seeds, iters)
    p, s = passable.to(device), seeds.to(device)
    before = _launches()
    got = flood.flood_fill(p, s, iters)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.bool
    n = p.shape[1] * p.shape[2] // 2 + 2 if iters is None else iters
    assert torch.equal(got, flood.flood_fill_plain(p, s, n))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_cuda_kernel_matches_plain(cuda_device, case):
    (h, w), density, iters = case
    _card_matches(*_case(h, w, density), iters, cuda_device)


@pytest.mark.cuda
def test_cuda_kernel_at_the_cells_shape(cuda_device):
    """[8192, 16, 16] at density 0.2 inside a border ring, seeds on
    passable tiles where there are some, at the bound and after 5."""
    rng = np.random.default_rng(16)
    passable = rng.random((8192, 16, 16)) >= 0.2
    passable[:, [0, -1], :] = False
    passable[:, :, [0, -1]] = False
    seeds = np.stack([rng.integers(1, 15, 8192), rng.integers(1, 15, 8192)], -1)
    passable[np.arange(8192)[::2], seeds[::2, 0], seeds[::2, 1]] = True
    for iters in (None, 5):
        _card_matches(torch.from_numpy(passable), torch.from_numpy(seeds.astype(np.int32)),
                      iters, cuda_device)


@pytest.mark.cuda
def test_cuda_kernel_at_the_limit(cuda_device):
    """The largest maps: 256 x 256 and 4096 words (256 x 512) open, over
    800 dilations (more than any path there needs), and a 128 x 256
    serpentine at the bound (which its path outruns)."""
    for h, w in ((256, 256), (256, 512)):
        open_, seeds = _case(h, w, 0.0)
        _card_matches(open_[:2].contiguous(), seeds[:2].contiguous(), 800, cuda_device)
    snake = torch.from_numpy(_serpentine(128, 256))[None]
    _card_matches(snake, torch.tensor([[0, 0]], dtype=torch.int32), None, cuda_device)


@pytest.mark.cuda
def test_cuda_one_launch_per_reset(cuda_device):
    """RandomRoom launches the fill once a reset: the first reset, then one
    budgeted reset a step."""
    env = rt.Env(rt.RandomRoom(rt.RandomRoomConfig(num_rays=16, height_camera_view_pu=16)),
                 num_envs=512, device=cuda_device, reset_budget=64)
    before = _launches()
    state, _ = env.reset(rt.rng.PRNGKey(1))
    for t in range(4):
        state = env.step(state, env.sample_action(rt.rng.PRNGKey(20 + t, cuda_device))).state
    torch.cuda.synchronize()
    assert _launches() == before + 5


@pytest.mark.cuda
def test_cuda_random_room_env_matches_cpu(cuda_device):
    """An 8192-env RandomRoom (16x16, density 0.2, the exact fill) with a
    reset budget of 256, episodes cut at 8 steps so the budget fills and
    envs wait, stepped 64 times on the card with sampled actions: every
    state and the last frames equal the CPU run's, one fill a reset."""
    cfg = rt.RandomRoomConfig(height_tile_map_tu=16, width_tile_map_tu=16, num_rays=32,
                              height_camera_view_pu=32, obs_type="camera_rgb",
                              max_episode_steps=8)
    runs = {}
    for dev in ("cpu", cuda_device):
        env = rt.Env(rt.RandomRoom(cfg), num_envs=8192, device=dev, reset_budget=256)
        before = _launches()
        state, _ = env.reset(rt.rng.PRNGKey(5))
        key = rt.rng.PRNGKey(6, dev)
        states = []
        for t in range(64):
            res = env.step(state, env.sample_action(rt.rng.fold_in(key, t)))
            state = res.state
            states.append(state.to_numpy())
        runs[str(dev)] = (states, res.obs.cpu(), _launches() - before)
    (cpu_states, cpu_obs, cpu_launches), (states, obs, launches) = runs.values()
    assert cpu_launches == 0 and launches == 65
    for t, (a, b) in enumerate(zip(cpu_states, states)):
        for leaf in a:
            np.testing.assert_array_equal(a[leaf], b[leaf], err_msg=f"step {t} {leaf}")
    assert torch.equal(obs, cpu_obs)
