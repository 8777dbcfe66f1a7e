"""The port's plain DDA (``ops/raycast.cast_rays_scan``) vs the JAX
package's ``cast_rays_scan`` (vmapped, with and without early exit) and
``cast_rays_scan_flat``: exact on every output.

The scan has no multiply feeding an add (``side`` is one product, then
sums), so XLA's FMA contraction on the CPU cannot move its floats: every
input is compared, rays with an exact-zero component and 45-degree rays
through grid corners included (the fuzz maps of tests/test_torch_crossing.py).
"""

import numpy as np
import pytest
import torch

from raycastworlds_tpu_torch.ops import raycast
from test_torch_crossing import SHAPES, _np, _torch, fuzz_case


def _jax_scan(words, pos, dirs, shape, steps, early_exit):
    import jax
    import jax.numpy as jnp
    from raycastworlds_tpu.ops import raycast as jraycast

    out = jax.jit(jax.vmap(
        lambda ww, p, d: jraycast.cast_rays_scan(
            ww, shape, p, d, steps, early_exit=early_exit)
    ))(jnp.asarray(words), jnp.asarray(pos), jnp.asarray(dirs))
    return [np.asarray(x) for x in out]


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("h,w", SHAPES)
def test_scan_matches_jax_scan(h, w, early_exit):
    words, pos, dirs = fuzz_case(h, w, 8, 64, seed=10, diagonal=True)
    want = _jax_scan(words, pos, dirs, (h, w), h + w, early_exit)
    wt, pt, dt = _torch(words, pos, dirs)
    got = raycast.cast_rays_scan(wt, (h, w), pt, dt, h + w, early_exit=early_exit)
    _assert_equal(_np(got), want)


@pytest.mark.parametrize("h,w", SHAPES)
def test_scan_matches_jax_scan_flat(h, w):
    import jax
    import jax.numpy as jnp
    from raycastworlds_tpu.ops import raycast as jraycast

    words, pos, dirs = fuzz_case(h, w, 5, 37, seed=11, diagonal=True)
    want = jax.jit(
        lambda ww, p, d: jraycast.cast_rays_scan_flat(ww, (h, w), p, d, h + w)
    )(jnp.asarray(words), jnp.asarray(pos), jnp.asarray(dirs))
    wt, pt, dt = _torch(words, pos, dirs)
    _assert_equal(_np(raycast.cast_rays_scan(wt, (h, w), pt, dt, h + w)),
                  [np.asarray(x) for x in want])


@pytest.mark.parametrize("steps", [0, 1, 3])
def test_truncated_trip_count(steps):
    """Rays still marching when the trip count runs out keep their last
    tile, hit_dim 0 and the largest float32 distance, as in JAX."""
    words, pos, dirs = fuzz_case(24, 40, 8, 33, seed=12, diagonal=True)
    want = _jax_scan(words, pos, dirs, (24, 40), steps, False)
    wt, pt, dt = _torch(words, pos, dirs)
    got = _np(raycast.cast_rays_scan(wt, (24, 40), pt, dt, steps))
    _assert_equal(got, want)
    assert (got[2] == np.finfo(np.float32).max).any()


def test_exact_zero_rays_in_an_empty_room():
    """From (3.5, 4.25) in an empty 8x16 room the axis rays hit the border
    at closed-form distances; the diagonal from an integer position steps
    j on every tie."""
    from raycastworlds_tpu_torch.ops.bitmap import pack_bits_np

    room = np.zeros((8, 16), bool)
    room[0, :] = room[-1, :] = room[:, 0] = room[:, -1] = True
    words = pack_bits_np(room)[None]
    s = np.float32(np.sqrt(0.5))
    dirs = np.array([[[1, 0], [-1, 0], [0, 1], [0, -1], [s, s]]], np.float32)
    pos = np.array([[3.5, 4.25]], np.float32)
    wt, pt, dt = _torch(words, pos, dirs)
    hit_tu, hit_dim, dist = _np(raycast.cast_rays_scan(wt, (8, 16), pt, dt, 24))
    np.testing.assert_array_equal(hit_tu[0, :4], [[7, 4], [0, 4], [3, 15], [3, 0]])
    np.testing.assert_array_equal(hit_dim[0, :4], [0, 0, 1, 1])
    np.testing.assert_array_equal(dist[0, :4], np.float32([3.5, 2.5, 10.75, 3.25]))
    _assert_equal([hit_tu, hit_dim, dist],
                  _jax_scan(words, pos, dirs, (8, 16), 24, False))


def test_early_exit_gives_identical_results():
    words, pos, dirs = fuzz_case(13, 9, 6, 40, seed=13, diagonal=True)
    wt, pt, dt = _torch(words, pos, dirs)
    a = raycast.cast_rays_scan(wt, (13, 9), pt, dt, 22, early_exit=False)
    b = raycast.cast_rays_scan(wt, (13, 9), pt, dt, 22, early_exit=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
