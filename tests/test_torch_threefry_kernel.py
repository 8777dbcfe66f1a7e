"""The threefry hash's CUDA kernel (``csrc/threefry.cu``) and its dispatch in
``raycastworlds_tpu_torch.rng``.

* On the CPU: the wrapper's counter geometry, as plain Python, reproduces the
  plain path's iota (``rng._counts``) for every shape, shard and axis; the
  wrapper, launching an emulation of the kernel (numpy over the launch's raw
  pointers), equals the plain path on every draw kind; a CPU key never
  reaches ``cuda_build``; a draw of 2**32 elements or more raises, and so
  does a launch of 2**32 - 256 (keys times elements) or more.
* On a CUDA card, the kernel against the plain path, bit for bit, for every
  draw kind, key shape and shard, one launch per hash, and a 4096-env
  SingleRoom ``Env`` stepped 64 times equal to the CPU run:
  ``python -m pytest tests/test_torch_threefry_kernel.py -m cuda --noconftest``.

This file imports no JAX: the plain path is the reference (it equals
``jax.random`` bit for bit, ``tests/test_torch_rng.py``).
"""

import ctypes
import itertools
import types

import numpy as np
import pytest
import torch

import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch import cuda_build, rng
from raycastworlds_tpu_torch.utils import profiling

TINY = float(np.finfo(np.float32).tiny)


def _keys(lead, seed=0):
    """int64 keys of leading shape ``lead`` with uint32 words, many with the
    top bit set, the first all ones."""
    words = np.random.default_rng(seed).integers(0, 2**32, size=tuple(lead) + (2,),
                                                 dtype=np.int64)
    words.reshape(-1, 2)[0] = 2**32 - 1
    return torch.from_numpy(words)


# -- the counter geometry -----------------------------------------------

GEOMETRY_CASES = [
    ((), None, 0), ((1,), None, 0), ((7,), None, 0), ((3, 5), None, 0),
    ((2, 3, 4), None, 0), ((0,), None, 0), ((4, 0, 3), None, 0),
] + [
    (shape, shard, axis)
    for shape in ((6,), (4, 5), (3, 4, 5), (2, 3, 4, 3))
    for axis in range(len(shape))
    for shard in ((0, shape[axis]), (0, 1), (1, shape[axis] - 1), (shape[axis] - 1, shape[axis]),
                  (2, 2))
]


def _counter(j, g):
    """The counter word of local element ``j`` of geometry ``g``, as the
    kernel computes it."""
    q, r = divmod(j, g.inner)
    o, a = divmod(q, g.local_len)
    return (o * g.global_len + g.start + a) * g.inner + r


@pytest.mark.parametrize("shape,shard,axis", GEOMETRY_CASES)
def test_geometry_reproduces_counts(shape, shard, axis):
    g = rng._geometry(shape, shard, axis)
    want = rng._counts(shape, "cpu", shard, axis)
    assert tuple(want.shape) == g.local
    got = [_counter(j, g) for j in range(want.numel())]
    assert got == want.flatten().tolist()


@pytest.mark.parametrize("draw", [
    lambda k: rng.random_bits(k, (2**32,)),
    lambda k: rng.random_bits(k, (2**16, 2**16)),
    lambda k: rng.random_bits(k, (2**33, 2), shard=(0, 4)),
    lambda k: rng.random_bits(k, (2, 2**32), shard=(0, 1), axis=0),
    lambda k: rng.split(k, 2**32),
    lambda k: rng.uniform(k, (2**20, 2**12)),
    lambda k: rng.randint(k, (2**32,), 0, 4),
], ids=["flat", "square", "shard_axis0", "shard_small", "split", "uniform", "randint"])
def test_draw_of_2_32_elements_raises(draw):
    """The high counter word is 0 only below 2**32 elements: the draw
    raises before it allocates anything."""
    with pytest.raises(ValueError, match="2\\*\\*32"):
        draw(rng.PRNGKey(0))


@pytest.mark.parametrize("lead,draw", [
    ((256,), lambda k: rng.random_bits(k, (2**24 - 1,))),
    ((2**16,), lambda k: rng.uniform(k, (2**16,))),
    ((2, 3), lambda k: rng.split(k, 2**31)),
], ids=["at_the_limit", "square", "split"])
def test_launch_of_2_32_minus_256_elements_raises(monkeypatch, lead, draw):
    """Each draw is below 2**32 elements, but the keys times its elements
    reach 2**32 - 256, where the kernel's uint32 thread index would wrap:
    the wrapper raises before it allocates or launches anything."""
    with pytest.raises(ValueError, match="2\\*\\*32 - 256"):
        _through_emulation(monkeypatch, draw, _keys(lead))


def test_geometry_below_2_32():
    g = rng._geometry((2**32 - 1,), (2**32 - 3, 2**32 - 1))
    assert g.local == (2,) and _counter(1, g) == 2**32 - 2


# -- every draw kind, named --------------------------------------------

def _draws():
    """name -> (fn(key) -> tensor, hashes per call)."""
    logits = torch.from_numpy(np.random.default_rng(3).normal(size=(6, 5)).astype(np.float32))
    return {
        "split_4": (lambda k: rng.split(k, 4), 1),
        "split_1": (lambda k: rng.split(k, 1), 1),
        "split_shard": (lambda k: rng.split(k, 64, (16, 40)), 1),
        "fold_in_0": (lambda k: rng.fold_in(k, 0), 1),
        "fold_in_big": (lambda k: rng.fold_in(k, 2**32 - 1), 1),
        "bits_scalar": (lambda k: rng.random_bits(k, ()), 1),
        "bits_3d": (lambda k: rng.random_bits(k, (2, 3, 4)), 1),
        "bits_shard_axis1": (lambda k: rng.random_bits(k, (3, 8, 2), (2, 7), axis=1), 1),
        "uniform": (lambda k: rng.uniform(k, (3, 5)), 1),
        "uniform_range": (lambda k: rng.uniform(k, (7,), -2.0, 3.0), 1),
        "uniform_shard_axis0": (lambda k: rng.uniform(k, (8, 3), shard=(5, 8)), 1),
        "randint_scalar": (lambda k: rng.randint(k, (), 0, 128), 3),
        "randint_array": (lambda k: rng.randint(k, (2,), [1, 1], [7, 15]), 3),
        "randint_shard_axis1": (lambda k: rng.randint(k, (2, 9), -3, 1000003, (4, 9), axis=1),
                                3),
        "bernoulli": (lambda k: rng.bernoulli(k, 0.3, (4, 4)), 1),
        "categorical_noise": (lambda k: rng.uniform(k, (6, 5), TINY, 1.0), 1),
        "categorical_shard": (lambda k: rng.categorical(k, logits[2:5].to(k.device),
                                                        shard=(2, 5)), 1),
    }


DRAWS = list(_draws())
ONE_KEY = {"categorical_shard"}  # categorical takes one key


def _lead_shapes(name):
    return [()] if name in ONE_KEY else [(), (5,), (4, 3)]


def _laid_out(key, layout):
    """The same keys in another memory layout: "strided", every third row
    of a wider tensor; "words_apart", the two words in separate planes (the
    last axis strided)."""
    if layout == "contiguous":
        return key
    if layout == "strided":
        wide = torch.zeros(key.shape[:-1] + (3, 2), dtype=key.dtype, device=key.device)
        wide[..., 1, :] = key
        return wide[..., 1, :]
    return key.movedim(-1, 0).contiguous().movedim(0, -1)


LAYOUTS = ["contiguous", "strided", "words_apart"]


# -- the wrapper on the CPU, launching an emulation of the kernel --------

_MASK = np.uint64(0xFFFFFFFF)


def _threefry_np(k0, k1, c):
    """Threefry-2x32 over counter words (0, c), as the kernel computes it
    (uint32 numpy arrays)."""
    with np.errstate(over="ignore"):
        rotl = lambda v, r: (v << np.uint32(r)) | (v >> np.uint32(32 - r))  # noqa: E731
        k2 = k0 ^ k1 ^ np.uint32(0x1BD11BDA)
        x0, x1 = k0.copy(), c + k1
        inject = ((k1, k2), (k2, k0), (k0, k1), (k1, k2), (k2, k0))
        for s, (a, b) in enumerate(inject):
            for r in ((13, 15, 26, 6), (17, 29, 16, 24))[s % 2]:
                x0 = x0 + x1
                x1 = rotl(x1, r) ^ x0
            x0 = x0 + a
            x1 = x1 + b + np.uint32(s + 1)
    return x0, x1


def _int64s(address, n):
    return np.ctypeslib.as_array((ctypes.c_int64 * n).from_address(address))


def _emulated_kernel(keys_ptr, key_stride, word_stride, out_ptr, total, n_local, inner,
                     local_len, global_len, start, pair):
    """``rcw_threefry`` on host memory: the C entry's arguments (without the
    stream), read and written as the kernel does."""
    i = np.arange(total, dtype=np.uint64)
    l = i // np.uint64(n_local)
    j = i - l * np.uint64(n_local)
    q = j // np.uint64(inner)
    c = ((q // np.uint64(local_len)) * np.uint64(global_len) + np.uint64(start)
         + q % np.uint64(local_len)) * np.uint64(inner) + j % np.uint64(inner)
    assert (c <= _MASK).all()
    n_keys = total // n_local
    keys = _int64s(keys_ptr, (n_keys - 1) * key_stride + word_stride + 1)
    rows = l.astype(np.int64) * key_stride
    x0, x1 = _threefry_np(keys[rows].astype(np.uint32), keys[rows + word_stride].astype(np.uint32),
                          c.astype(np.uint32))
    if pair:
        _int64s(out_ptr, 2 * total)[:] = np.stack([x0, x1], -1).reshape(-1)
    else:
        _int64s(out_ptr, total)[:] = x0 ^ x1


def _through_emulation(monkeypatch, fn, key):
    """``fn(key)`` with the hash dispatched as for a CUDA key, the kernel's
    launch going to the emulation; (result, launches made)."""
    launches = []

    def launch(entry, device, *args, what):
        assert entry is _emulated_kernel and what == "threefry" and device.type == "cpu"
        launches.append(args)
        entry(*args)

    with monkeypatch.context() as m:
        m.setattr(rng, "_uses_kernel", lambda key: True)
        m.setattr(cuda_build, "load", lambda: types.SimpleNamespace(rcw_threefry=_emulated_kernel))
        m.setattr(cuda_build, "launch", launch)
        return fn(key), launches


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", DRAWS)
def test_wrapper_equals_plain_path(monkeypatch, name, layout):
    """Every draw kind, keys of leading shape (), [5] and [4, 3] in every
    layout: the wrapper's launch arguments make the kernel compute the
    plain path's bits, in one launch a hash."""
    fn, hashes = _draws()[name]
    for lead in _lead_shapes(name):
        key = _laid_out(_keys(lead, seed=len(lead)), layout)
        want = fn(key)
        got, launches = _through_emulation(monkeypatch, fn, key)
        assert len(launches) == hashes
        assert got.dtype == want.dtype and got.shape == want.shape, lead
        assert torch.equal(got, want), lead


def test_wrapper_large_draw(monkeypatch):
    """One draw of 2**20 elements, and a permutation of 2**20 (two sort
    rounds, two hashes each)."""
    key = _keys((), seed=7)
    for fn, hashes in ((lambda k: rng.random_bits(k, (2**20,)), 1),
                       (lambda k: rng.permutation(k, 2**20), 4)):
        got, launches = _through_emulation(monkeypatch, fn, key)
        assert len(launches) == hashes
        assert torch.equal(got, fn(key))


def test_wrapper_refuses_other_keys(monkeypatch):
    for bad in (torch.zeros(3, 2, dtype=torch.int32), torch.zeros(3, 3, dtype=torch.int64)):
        with pytest.raises(ValueError, match="int64"):
            _through_emulation(monkeypatch, lambda k: rng.split(k), bad)


def test_empty_draw_launches_nothing(monkeypatch):
    key = _keys((4,))
    for fn, shape in ((lambda k: rng.random_bits(k, (3, 0)), (4, 3, 0)),
                      (lambda k: rng.split(k[:0]), (0, 2, 2))):
        got, launches = _through_emulation(monkeypatch, fn, key)
        assert launches == [] and tuple(got.shape) == shape


# -- a CPU key takes the plain path -------------------------------------

def _never(*args, **kwargs):
    raise AssertionError("a CPU key reached cuda_build")


@pytest.mark.parametrize("name", DRAWS + ["permutation"])
def test_cpu_key_never_reaches_cuda_build(monkeypatch, name):
    monkeypatch.setattr(cuda_build, "load", _never)
    monkeypatch.setattr(cuda_build, "launch", _never)
    fn = (lambda k: rng.permutation(k, 100)) if name == "permutation" else _draws()[name][0]
    before = profiling.total("kernel_launches.threefry")
    for lead in _lead_shapes(name) if name != "permutation" else [()]:
        out = fn(_keys(lead))
        assert out.device.type == "cpu"
    assert profiling.total("kernel_launches.threefry") == before


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _launches():
    return profiling.total("kernel_launches.threefry")


@pytest.mark.cuda
@pytest.mark.parametrize("name", DRAWS)
def test_cuda_kernel_matches_plain(cuda_device, name):
    """Every draw kind on keys of leading shape (), [5] and [4, 3] (top
    bits set) in every layout: the kernel's bits are the plain path's, one
    launch a hash."""
    fn, hashes = _draws()[name]
    for lead, layout in itertools.product(_lead_shapes(name), LAYOUTS):
        key = _keys(lead, seed=len(lead) + 10)
        want = fn(key)
        before = _launches()
        got = fn(_laid_out(key.to(cuda_device), layout))
        torch.cuda.synchronize()
        assert _launches() == before + hashes, (lead, layout)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want), (lead, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 4097, 2**20])
def test_cuda_permutation(cuda_device, n):
    key = _keys((), seed=n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(2**32 - 1)))
    before = _launches()
    got = rng.permutation(key.to(cuda_device), n)
    torch.cuda.synchronize()
    assert _launches() == before + 2 * rounds
    assert torch.equal(got.cpu(), rng.permutation(key, n))


@pytest.mark.cuda
def test_cuda_large_draw(cuda_device):
    """2**20 elements for each of 3 keys, and a shard of a 2**20-element
    draw on axis 1."""
    key = _keys((3,), seed=5)
    for fn in (lambda k: rng.random_bits(k, (2**20,)),
               lambda k: rng.split(k, 2**20),
               lambda k: rng.random_bits(k, (4, 2**18), (1000, 2**18 - 7), axis=1)):
        assert torch.equal(fn(key.to(cuda_device)).cpu(), fn(key))


@pytest.mark.cuda
def test_cuda_sample_action_and_reset_shards(cuda_device):
    """The mesh's sharded draws: a rank's rows are that slice of the
    one-process draw (Env.reset's split, Env.sample_action's randint)."""
    key = rng.PRNGKey(11)
    full_keys = rng.split(key.to(cuda_device), 4096)
    full_act = rng.randint(key.to(cuda_device), (4096, 2), 0, 4)
    for start, stop in ((0, 2048), (2048, 4096), (1000, 1001)):
        assert torch.equal(rng.split(key.to(cuda_device), 4096, (start, stop)),
                           full_keys[start:stop])
        assert torch.equal(rng.randint(key.to(cuda_device), (4096, 2), 0, 4, (start, stop)),
                           full_act[start:stop])
    assert torch.equal(full_keys.cpu(), rng.split(key, 4096))


@pytest.mark.cuda
def test_cuda_env_matches_cpu(cuda_device):
    """A 4096-env SingleRoom at 64 rays x 64 px, dense auto-reset, stepped
    64 times on the card with sampled actions: every state and the last
    frames equal the CPU run's, and each reset hashed 8 times."""
    cfg = rt.EnvConfig(num_rays=64, height_camera_view_pu=64)
    runs = {}
    for dev in ("cpu", cuda_device):
        env = rt.Env(rt.SingleRoom(cfg), num_envs=4096, device=dev)
        state, obs = env.reset(rng.PRNGKey(5))
        key = rng.PRNGKey(6, dev)
        states = []
        before = _launches()
        for t in range(64):
            action = env.sample_action(rng.fold_in(key, t))
            res = env.step(state, action)
            state = res.state
            states.append(state.to_numpy())
        runs[str(dev)] = (states, res.obs.cpu(), _launches() - before)
    (cpu_states, cpu_obs, cpu_launches), (states, obs, launches) = runs.values()
    assert cpu_launches == 0
    # per step: fold_in 1, sample_action's randint 3, the reset 8
    assert launches == 64 * (1 + 3 + 8)
    for t, (a, b) in enumerate(zip(cpu_states, states)):
        for leaf in a:
            np.testing.assert_array_equal(a[leaf], b[leaf], err_msg=f"step {t} {leaf}")
    assert torch.equal(obs, cpu_obs)
