"""Threefry-2x32 counter-based random numbers in plain torch integer ops.

The counterpart of ``jax.random`` as the engine uses it, reproducing JAX's
bits exactly (JAX 0.9 with ``jax_threefry_partitionable=True``, its
default): ``PRNGKey``, ``split``, ``fold_in``, ``randint``, float32
``uniform`` and ``bernoulli``, and for the trainers ``categorical`` and
``permutation``.
All of the engine's randomness enters through these draws, with per-env
keys, which is what makes trajectories reproducible per env and independent
of the batch size.

A key is two uint32 words held as int64 values in ``[0, 2**32)`` (torch has
no usable uint32 arithmetic), shape ``[..., 2]``.  Every function accepts a
batch of keys: the leading dimensions of ``key`` stay leading dimensions of
the result, and each key draws exactly what ``jax.random`` would draw for it
alone.

The hash dispatches on the key's device.  A CUDA key goes to the CUDA
kernel ``csrc/threefry.cu`` (one launch a hash, counted as
``kernel_launches.threefry``); any other key takes the plain version,
:func:`threefry2x32` in int64 tensor ops, which the tests hold the kernel
to bit for bit.  Everything after the hash is ordinary tensor arithmetic on
the key's device.

Each draw takes ``shard=(start, stop)`` (and ``axis``, 0 by default): it
then returns only the elements of the global ``shape`` whose index along
``axis`` lies in ``[start, stop)``, exactly that slice of the full draw.
With partitionable threefry an element's bits depend only on the key and
its row-major position in the global shape, so a data-parallel rank draws
its own rows, and its work does not grow with the number of ranks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import cuda_build
from .utils import profiling

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


@profiling.span("rcw.rng.threefry")
def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds), elementwise over
    broadcastable int64 operands holding uint32 values."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 range: the key
    words are (0, seed as uint32)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError("seed must fit in int32")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


Shard = Optional[Tuple[int, int]]


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


class _Geometry(NamedTuple):
    """The counters of a draw's local elements, as the kernel computes them:
    local element ``j`` (row-major in ``local``) has the counter
    ``(o * global_len + start + a) * inner + r``, where ``r = j % inner``,
    ``a = j // inner % local_len`` and ``o = j // inner // local_len``."""

    local: Tuple[int, ...]
    inner: int
    start: int
    local_len: int
    global_len: int


def _geometry(shape: Tuple[int, ...], shard: Shard = None, axis: int = 0) -> _Geometry:
    """The counter geometry of a draw of ``shape`` (or its ``shard`` on
    ``axis``), from the shape alone.  Raises where the draw's global size
    reaches 2**32: the high counter word is 0 only below that."""
    n = _numel(shape)
    if n >= 2**32:
        raise ValueError(f"a draw of {shape} has 2**32 elements or more")
    if shard is None:
        return _Geometry(shape, 1, 0, n, n)
    start, stop = shard
    if not 0 <= start <= stop <= shape[axis]:
        raise ValueError(f"shard {shard} outside axis {axis} of {shape}")
    local = shape[:axis] + (stop - start,) + shape[axis + 1:]
    return _Geometry(local, _numel(shape[axis + 1:]), start, stop - start, shape[axis])


def _counts(shape: Tuple[int, ...], device, shard: Shard = None, axis: int = 0) -> torch.Tensor:
    """Row-major iota over ``shape``: the counter words of one draw (the
    high counter word is 0 for every size this engine draws).  With
    ``shard=(start, stop)``, only the elements whose index along ``axis``
    lies in ``[start, stop)``: that slice of the iota (a shard that
    ``_geometry`` accepts)."""
    if shard is None:
        return torch.arange(_numel(shape), dtype=torch.int64, device=device).reshape(shape)
    start, stop = shard
    local = list(shape)
    local[axis] = stop - start
    counts = torch.zeros(local, dtype=torch.int64, device=device)
    stride = 1
    for d in range(len(shape) - 1, -1, -1):
        iota = torch.arange(local[d], dtype=torch.int64, device=device)
        if d == axis:
            iota = iota + start
        counts = counts + (iota * stride).reshape([-1 if i == d else 1 for i in range(len(shape))])
        stride *= shape[d]
    return counts


def _uses_kernel(key: torch.Tensor) -> bool:
    """The hash's dispatch: a CUDA key goes to the kernel (or raises), any
    other takes the plain version."""
    return key.device.type == "cuda"


@profiling.span("rcw.rng.threefry")
def _hash_kernel(key: torch.Tensor, g: _Geometry, pair: bool) -> torch.Tensor:
    """The CUDA kernel's hash of ``key`` (any leading shape) over geometry
    ``g``: both output words on a last axis of 2 (``pair``), or their xor.
    One launch, no other device work: the keys are read through their
    strides, the output is allocated empty.  Raises where the keys times
    the local elements reach 2**32 - 256, where the kernel's uint32 thread
    index would wrap."""
    if key.dtype != torch.int64 or key.shape[-1:] != (2,):
        raise ValueError(f"keys must be int64 [..., 2], not {key.dtype} {list(key.shape)}")
    lead = key.shape[:-1]
    total = _numel(lead) * _numel(g.local)
    if total >= 2**32 - 256:
        raise ValueError(f"{_numel(lead)} keys x {g.local} draws {total} elements, "
                         f"2**32 - 256 or more in one launch")
    out = torch.empty(lead + g.local + ((2,) if pair else ()), dtype=torch.int64,
                      device=key.device)
    if total == 0:
        return out
    keys = key.reshape(-1, 2)  # a view wherever the leading axes allow one
    lib = cuda_build.load()
    cuda_build.launch(lib.rcw_threefry, key.device, keys.data_ptr(), keys.stride(0),
                      keys.stride(1), out.data_ptr(), total, _numel(g.local), g.inner,
                      g.local_len, g.global_len, g.start, int(pair), what="threefry")
    return out


def _hash(key: torch.Tensor, shape: Tuple[int, ...], shard: Shard = None, axis: int = 0,
          pair: bool = False) -> torch.Tensor:
    """Threefry over the iota of ``shape`` (or its ``shard``), per key: both
    output words on a last axis of 2 (``pair``) or their xor, shape
    ``[*key.shape[:-1], *local shape(, 2)]``.  A CUDA key launches the
    kernel; any other takes :func:`threefry2x32`."""
    g = _geometry(shape, shard, axis)
    if _uses_kernel(key):
        return _hash_kernel(key, g, pair)
    lead = key.shape[:-1]
    counts = _counts(shape, key.device, shard, axis)
    expand = (...,) + (None,) * counts.dim()
    k0 = key[..., 0][expand]
    k1 = key[..., 1][expand]
    counts = counts.reshape((1,) * len(lead) + tuple(counts.shape))
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(counts), counts)
    return torch.stack([b0, b1], dim=-1) if pair else b0 ^ b1


def split(key: torch.Tensor, num: int = 2, shard: Shard = None) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` keys -> ``[..., num, 2]``; with
    ``shard=(start, stop)`` only those of the ``num`` keys."""
    return _hash(key, (num,), shard, pair=True)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: threefry of the key over the
    counter words (0, data as uint32).  ``[..., 2]`` keys -> ``[..., 2]``."""
    data = int(data)
    if not 0 <= data < 2**32:
        raise ValueError("fold_in data must fit in uint32")
    if _uses_kernel(key):  # one element, its counter data
        return _hash_kernel(key, _Geometry((), 1, data, 1, 1), pair=True)
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], zero, zero + data)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int], shard: Shard = None,
                axis: int = 0) -> torch.Tensor:
    """32 random bits per element (int64 in ``[0, 2**32)``), shape
    ``[*key.shape[:-1], *shape]`` (``shard``: see the module docstring)."""
    return _hash(key, tuple(shape), shard, axis)


def uniform(
    key: torch.Tensor,
    shape: Sequence[int] = (),
    minval: float = 0.0,
    maxval: float = 1.0,
    shard: Shard = None,
    axis: int = 0,
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits fill the mantissa of a float in [1, 2), minus 1, then scaled."""
    bits = random_bits(key, shape, shard, axis)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int], shard: Shard = None,
              axis: int = 0) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``:
    ``uniform(key, shape) < p`` with ``p`` rounded to float32 first, as JAX
    compares against the weakly typed scalar."""
    u = uniform(key, shape, shard=shard, axis=axis)
    return u < torch.tensor(np.float32(p), device=key.device)


IntBound = Union[int, Sequence[int]]


def randint(
    key: torch.Tensor, shape: Sequence[int], minval: IntBound, maxval: IntBound,
    shard: Shard = None, axis: int = 0,
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)``.

    ``minval``/``maxval`` are ints or int sequences that broadcast against
    ``shape`` (as in the goal draw, bounds ``[1, 1]`` to ``[H-1, W-1]``;
    against the slice under ``shard``).
    JAX draws two 32-bit words per element from ``split(key)`` and reduces
    them modulo the span with a double-width remainder identity.
    """
    shape = tuple(shape)
    dev = key.device
    lo = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    for v in (lo, hi):
        if v.numel() and not bool(
            ((v >= -(2**31)) & (v < 2**31)).all()
        ):
            raise ValueError("randint bounds must fit in int32")
    k = split(key, 2)
    higher = random_bits(k[..., 0, :], shape, shard, axis)
    lower = random_bits(k[..., 1, :], shape, shard, axis)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & _MASK)
    # uint32 arithmetic: every product wraps at 2**32, as in JAX.
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = ((higher % span) * multiplier) & _MASK
    offset = ((offset + lower % span) & _MASK) % span
    return (lo + offset).to(torch.int32)


def categorical(key: torch.Tensor, logits: torch.Tensor, shard: Shard = None) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis (one key,
    float32 logits): the argmax of ``logits`` plus Gumbel noise drawn in
    JAX's "low" mode, ``-log(-log(u))`` with ``u`` uniform in [float32 tiny,
    1).  The uniform bits are exact; ``log`` may differ from XLA's by an
    ulp, so only a near tie between two actions can pick another one.
    ``shard=(start, stop)``: ``logits`` are those rows (axis 0) of the
    global logits, and the noise is that slice of the global draw.
    Returns int32 of ``logits.shape[:-1]``."""
    tiny = float(np.finfo(np.float32).tiny)
    shape = tuple(logits.shape)
    if shard is not None:
        shape = (shard[1],) + shape[1:]
    u = uniform(key, shape, minval=tiny, maxval=1.0, shard=shard)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(gumbel + logits, dim=-1).to(torch.int32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``, exactly: JAX's sort shuffle of
    ``arange(n)``, ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each splitting
    the key, drawing 32 bits per element and sorting stably by them.
    Returns int64[n]."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key).unbind(0)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x
