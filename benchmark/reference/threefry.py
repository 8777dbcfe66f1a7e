"""Threefry-2x32 and the draws SingleRoom's reset makes, in plain NumPy.

A frozen copy of the counter-based generator that ``jax.random`` uses with
``jax_threefry_partitionable=True`` (its default), written on NumPy's
``uint32``, whose arithmetic wraps at 2**32 as the cipher needs.  A key is
two ``uint32`` words, shape ``[..., 2]``; every function takes a batch of
keys and draws for each key what ``jax.random`` draws for that key alone.
An element's bits depend only on the key and its row-major index in the
drawn shape: the counter words are (0, index).
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher, 20 rounds, elementwise over
    broadcastable ``uint32`` arrays.  Returns the two output words."""
    k0, k1, x0, x1 = (np.asarray(v, dtype=_U32) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << _U32(r)) | (x1 >> _U32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def key_of_seed(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: words (0, seed)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=_U32)


def _hash(keys: np.ndarray, n: int):
    """Both cipher words over counters 0..n-1, per key: ``[..., n]`` each."""
    counts = np.arange(n, dtype=_U32)
    return threefry2x32(keys[..., 0, None], keys[..., 1, None], _U32(0), counts)


def split(keys: np.ndarray, num: int) -> np.ndarray:
    """``jax.random.split``: ``[..., 2]`` keys -> ``[..., num, 2]``."""
    b0, b1 = _hash(keys, num)
    return np.stack([b0, b1], axis=-1)


def random_bits(keys: np.ndarray, n: int) -> np.ndarray:
    """32 random bits for each of ``n`` elements per key: ``[..., n]``."""
    b0, b1 = _hash(keys, n)
    return b0 ^ b1


def uniform(keys: np.ndarray) -> np.ndarray:
    """One float32 uniform in [0, 1) per key: the top 23 bits fill the
    mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(keys, 1)[..., 0]
    return ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)


def randint(keys: np.ndarray, n: int, lo, hi) -> np.ndarray:
    """``jax.random.randint(key, (n,), lo, hi)`` per key, int64 ``[..., n]``;
    ``lo``/``hi`` broadcast against the last axis.  Two 32-bit words per
    element from ``split(key)``, reduced modulo the span with the
    double-width remainder identity, every product wrapping at 2**32."""
    k = split(keys, 2)
    higher = random_bits(k[..., 0, :], n)
    lower = random_bits(k[..., 1, :], n)
    lo = np.broadcast_to(np.asarray(lo, dtype=np.int64), higher.shape)
    hi = np.broadcast_to(np.asarray(hi, dtype=np.int64), higher.shape)
    span = np.where(hi <= lo, 1, hi - lo).astype(_U32)
    multiplier = _U32(2**16) % span
    multiplier = (multiplier * multiplier) % span
    offset = ((higher % span) * multiplier + lower % span) % span
    return lo + offset.astype(np.int64)
