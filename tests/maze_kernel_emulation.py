"""``rcw_maze_reset`` (``csrc/maze_reset.cu``) emulated in numpy on host
memory, for the CPU tests of the Maze reset's dispatch.

:func:`rcw_maze_reset` takes the C entry's arguments (the stream is
ignored): it reads the keys through their strides and writes every leaf as the kernel
does.  It computes what the kernel computes, in the kernel's terms: the
packed map built a flat word at a time from the carve, each room drawn
from its own key and cleared over its interior rows as bit ranges of the
words, the ranks from the words' open counts and the k-th open tile picked
inside its word.  Only the warp's lanes become numpy's axes.  It imports
nothing of the port: a test that launches it through the port's wrapper
holds the wrapper's arguments and the kernel's arithmetic to the plain
path.
"""

import ctypes
import os
import re

import numpy as np

SOURCE = os.path.join(os.path.dirname(__file__), os.pardir, "raycastworlds_tpu_torch", "csrc",
                      "maze_reset.cu")


def constant(name):
    """The kernel source's ``constexpr int <name>``."""
    with open(SOURCE) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


_U32 = np.uint32


def _threefry(k0, k1, c):
    """Threefry-2x32 of keys (k0, k1) over the counter words (0, c): uint32
    arrays, broadcast."""
    k0, k1, c = (np.asarray(v, _U32) for v in (k0, k1, c))
    rotl = lambda v, r: (v << _U32(r)) | (v >> _U32(32 - r))  # noqa: E731
    k2 = k0 ^ k1 ^ _U32(0x1BD11BDA)
    x0, x1 = k0 + np.zeros_like(c), c + k1
    inject = ((k1, k2), (k2, k0), (k0, k1), (k1, k2), (k2, k0))
    for s, (a, b) in enumerate(inject):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[s % 2]:
            x0 = x0 + x1
            x1 = rotl(x1, r) ^ x0
        x0 = x0 + a
        x1 = x1 + b + _U32(s + 1)
    return x0, x1


def _split(key, i):
    """Key ``i`` of ``split(key)``: a pair of uint32 arrays."""
    return _threefry(key[0], key[1], i)


def _bits(key, c):
    x0, x1 = _threefry(key[0][..., None], key[1][..., None], c)
    return x0 ^ x1


def _unit_float(b):
    return ((b >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1)


def _randint_offset(higher, lower, span):
    m = 65536 % span
    m = ((m * m) & 0xFFFFFFFF) % span
    span, m = _U32(span), _U32(m)
    return ((higher % span) * m + lower % span) % span


def _randint2(key, span0, span1):
    """randint of shape (2,): both offsets, each [B]."""
    hk, lk = _split(key, 0), _split(key, 1)
    higher, lower = _bits(hk, np.arange(2, dtype=_U32)), _bits(lk, np.arange(2, dtype=_U32))
    return (_randint_offset(higher[:, 0], lower[:, 0], span0),
            _randint_offset(higher[:, 1], lower[:, 1], span1))


def _span(lo, hi):
    return 1 if hi <= lo else hi - lo


def _rank_draw(u, n):
    hi = np.maximum(n - np.float32(1), np.float32(0))
    return np.minimum(np.maximum(np.floor(u * n), np.float32(0)), hi)


def _popcount(words):
    return np.unpackbits(words.astype(_U32)[..., None].view(np.uint8), axis=-1).sum(-1)


def _nth_bit(m, k):
    m = int(m)
    for _ in range(k):
        m &= m - 1
    return (m & -m).bit_length() - 1


def _array(ctype, address, n):
    return np.ctypeslib.as_array((ctype * n).from_address(address))


def rcw_maze_reset(keys_ptr, key_stride, word_stride, wall_ptr, goal_ptr, pos_ptr, dir_ptr,
                   reward_ptr, done_ptr, key_ptr, t_ptr, return_ptr, pending_ptr, b, h, w,
                   num_rooms, room_max_half, num_directions, continuous, f64, stream=None):
    """The kernel on host memory, from the C entry's arguments; 0, the C
    entry's "launched", for ``cuda_build.launch``."""
    tiles = h * w
    nw = -(-tiles // 32)
    assert b >= 1 and h >= 5 and w >= 5 and nw <= constant("kMaxWords")
    assert num_rooms >= 0 and num_directions >= 1
    keys = _array(ctypes.c_int64, keys_ptr, (b - 1) * key_stride + word_stride + 1)
    rows = np.arange(b) * key_stride
    key = (keys[rows].astype(_U32), keys[rows + word_stride].astype(_U32))
    nxt, k_map, k_goal, k_spawn, k_dir = (_split(key, q) for q in range(5))
    k_coin = _split(k_map, 0)
    cw = (w - 1) // 2

    # the carve, word by word: tile f = 32 q + lane
    f = np.arange(nw * 32)
    i, j = f // w, f % w
    ci, cj = i >> 1, j >> 1
    coin = _unit_float(_bits(k_coin, (ci * cw + cj).astype(_U32))) < np.float32(0.5)
    odd_i, odd_j = (i & 1) == 1, (j & 1) == 1
    wall = np.ones((b, nw * 32), bool)
    wall[:, odd_i & odd_j] = False
    west = odd_i & ~odd_j & (j > 0) & (j < w - 1)
    wall[:, west] = (ci[west] > 0) & coin[:, west]
    north = ~odd_i & odd_j & (i > 0) & (i < h - 1)
    wall[:, north] = (cj[north] > 0) & ~coin[:, north]
    wall[:, f >= tiles] = False
    weights = _U32(1) << np.arange(32, dtype=_U32)
    words = np.bitwise_or.reduce(wall.reshape(b, nw, 32) * weights, axis=-1).astype(_U32)

    # the rooms: each cleared over its interior rows, bit ranges of words
    if num_rooms > 0:
        k_rooms = _split(k_map, 1)
        span_half = _span(1, room_max_half + 1)
        for r in range(num_rooms):
            room = _split(k_rooms, r)
            oi, oj = _randint2(_split(room, 0), _span(1, h - 1), _span(1, w - 1))
            ohi, ohj = _randint2(_split(room, 1), span_half, span_half)
            for e in range(b):
                rci, rcj = 1 + int(oi[e]), 1 + int(oj[e])
                rhi, rhj = 1 + min(int(ohi[e]), h), 1 + min(int(ohj[e]), w)
                j0, j1 = max(rcj - rhj, 1), min(rcj + rhj, w - 2)
                for row in range(max(rci - rhi, 1), min(rci + rhi, h - 2) + 1):
                    s, end = row * w + j0, row * w + j1
                    for q in range(s >> 5, (end >> 5) + 1):
                        lo, top = max(s, 32 * q) - 32 * q, min(end, 32 * q + 31) - 32 * q
                        words[e, q] &= ~_U32((0xFFFFFFFF >> (31 - (top - lo))) << lo)

    # the ranks, and the k-th open tile inside its word
    rest = tiles - 32 * np.arange(nw)
    valid = np.where(rest < 32, (_U32(1) << np.minimum(rest, 31).astype(_U32)) - _U32(1),
                     _U32(0xFFFFFFFF)).astype(_U32)
    open_ = ~words & valid
    counts = _popcount(open_)
    n = counts.sum(-1).astype(np.float32)
    k1 = _rank_draw(_unit_float(_bits(k_goal, _U32(0))[:, 0]), n)
    k2 = _rank_draw(_unit_float(_bits(k_spawn, _U32(0))[:, 0]), n - np.float32(1))
    k2 = k2 + (k1 <= k2).astype(np.float32)
    found = np.zeros((b, 2), np.int64)
    for e in range(b):
        excl = np.cumsum(counts[e]) - counts[e]
        for s, rank in enumerate((int(k1[e]), int(k2[e]))):
            (hit,) = np.nonzero((excl <= rank) & (rank < excl + counts[e]))
            if hit.size:
                q = int(hit[0])
                found[e, s] = 32 * q + _nth_bit(open_[e, q], rank - int(excl[q]))
    goal, spawn = found[:, 0], found[:, 1]

    if continuous:
        u = _unit_float(_bits(k_dir, _U32(0))[:, 0])
        heading = np.maximum(np.float32(0), u * np.float32(num_directions) + np.float32(0))
        heading = heading.view(np.int32)
    else:
        higher = _bits(_split(k_dir, 0), _U32(0))[:, 0]
        lower = _bits(_split(k_dir, 1), _U32(0))[:, 0]
        heading = _randint_offset(higher, lower, _span(0, num_directions)).astype(np.int32)

    _array(ctypes.c_int32, wall_ptr, b * nw)[:] = words.view(np.int32).reshape(-1)
    _array(ctypes.c_int32, goal_ptr, 2 * b)[:] = np.stack([goal // w, goal % w], -1).reshape(-1)
    pos = np.stack([spawn // w, spawn % w], -1).reshape(-1)
    if f64:
        _array(ctypes.c_double, pos_ptr, 2 * b)[:] = pos.astype(np.float64) + 0.5
    else:
        _array(ctypes.c_float, pos_ptr, 2 * b)[:] = pos.astype(np.float32) + np.float32(0.5)
    _array(ctypes.c_int32, dir_ptr, b)[:] = heading
    _array(ctypes.c_int64, key_ptr, 2 * b)[:] = np.stack(nxt, -1).astype(np.int64).reshape(-1)
    _array(ctypes.c_float, reward_ptr, b)[:] = 0
    _array(ctypes.c_uint8, done_ptr, b)[:] = 0
    _array(ctypes.c_int32, t_ptr, b)[:] = 0
    _array(ctypes.c_float, return_ptr, b)[:] = 0
    _array(ctypes.c_uint8, pending_ptr, b)[:] = 0
    return 0
