"""Port ops vs the JAX package: bitmap, collision and sampling (exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raycastworlds_tpu.ops import bitmap as jbitmap
from raycastworlds_tpu.ops import collision as jcollision
from raycastworlds_tpu.ops import sampling as jsampling
from raycastworlds_tpu_torch import rng
from raycastworlds_tpu_torch.ops import bitmap, collision, lut, sampling

SHAPES = [(8, 16), (13, 9), (3, 3), (24, 40), (48, 48)]


def _maps(h, w, b=6, seed=0):
    r = np.random.default_rng(seed)
    m = r.random((b, h, w)) < 0.4
    m[:, 0, :] = m[:, -1, :] = True
    m[:, :, 0] = m[:, :, -1] = True
    return m


def _words_t(words_np):
    return torch.from_numpy(np.array(words_np, np.uint32).view(np.int32))


@pytest.mark.parametrize("h,w", SHAPES)
def test_pack_unpack(h, w):
    m = _maps(h, w)
    want = np.asarray(jax.vmap(jbitmap.pack_bits)(jnp.asarray(m)))
    got = bitmap.pack_bits(torch.from_numpy(m)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jbitmap.pack_bits_np(m))
    np.testing.assert_array_equal(bitmap.pack_bits_np(m), jbitmap.pack_bits_np(m))
    back = bitmap.unpack_bits(_words_t(want), (h, w)).numpy()
    np.testing.assert_array_equal(back, m)
    np.testing.assert_array_equal(
        back, np.asarray(jax.vmap(lambda x: jbitmap.unpack_bits(x, (h, w)))(want))
    )


@pytest.mark.parametrize("h,w", SHAPES)
def test_lookup_bit(h, w):
    m = _maps(h, w, seed=1)
    words = jbitmap.pack_bits_np(m)
    idx = np.random.default_rng(2).integers(0, h * w, size=(m.shape[0], 50), dtype=np.int32)
    want = np.asarray(jax.vmap(jbitmap.lookup_bit)(jnp.asarray(words), jnp.asarray(idx)))
    got = bitmap.lookup_bit(_words_t(words), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_take_rows():
    table = np.random.default_rng(3).standard_normal((128, 64, 2)).astype(np.float32)
    idx = np.random.default_rng(4).integers(0, 128, size=17, dtype=np.int32)
    got = lut.take_rows(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, table[idx])


def _positions(h, w, b, seed):
    r = np.random.default_rng(seed)
    return r.uniform([0.6, 0.6], [h - 0.6, w - 0.6], size=(b, 2)).astype(np.float32)


@pytest.mark.parametrize("h,w", [(8, 16), (13, 9), (24, 40)])
@pytest.mark.parametrize("radius", [0.125, 0.3, 0.49])
def test_collision(h, w, radius):
    b = 64
    m = _maps(h, w, b=b, seed=5)
    words = jbitmap.pack_bits_np(m)
    pos = _positions(h, w, b, 6)
    # also points exactly on tile edges and centres
    pos[:8] = np.floor(pos[:8]) + np.float32(0.5)
    pos[8:16] = np.floor(pos[8:16])
    wj, pj = jnp.asarray(words), jnp.asarray(pos)
    wt, pt = _words_t(words), torch.from_numpy(pos)

    want = np.asarray(jax.vmap(
        lambda ww, p: jcollision.is_player_colliding_packed(ww, (h, w), p, radius)
    )(wj, pj))
    got = collision.is_player_colliding_packed(wt, (h, w), pt, radius).numpy()
    np.testing.assert_array_equal(got, want)

    want = np.asarray(jax.vmap(
        lambda ww, p: jcollision.colliding_occupied_words(ww, (h, w), p, radius)
    )(wj, pj))
    got = collision.colliding_occupied_words(wt, (h, w), pt, radius).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)

    goal = np.random.default_rng(7).integers(1, [h - 1, w - 1], size=(b, 2)).astype(np.int32)
    goal[:16] = np.floor(pos[:16]).astype(np.int32)
    want = np.asarray(jax.vmap(
        lambda p, g: jcollision.is_colliding_with_goal(p, g, radius)
    )(pj, jnp.asarray(goal)))
    got = collision.is_colliding_with_goal(pt, torch.from_numpy(goal), radius).numpy()
    np.testing.assert_array_equal(got, want)


def _keys(n, seed):
    seeds = np.random.default_rng(seed).integers(0, 2**31, size=n)
    kj = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.int32))
    kt = torch.stack([rng.PRNGKey(int(s)) for s in seeds])
    return kj, kt


@pytest.mark.parametrize("h,w", [(8, 16), (3, 3), (13, 9), (64, 64)])
def test_sample_interior_tile(h, w):
    kj, kt = _keys(100, 8)
    want = np.asarray(jax.vmap(lambda k: jsampling.sample_interior_tile(k, h, w))(kj))
    got = sampling.sample_interior_tile(kt, h, w).numpy()
    np.testing.assert_array_equal(got, want)
    want_r = np.asarray(jax.vmap(lambda t: jsampling.interior_rank(t, w))(jnp.asarray(want)))
    np.testing.assert_array_equal(
        sampling.interior_rank(torch.from_numpy(got), w).numpy(), want_r
    )


@pytest.mark.parametrize("d", [1, 4, 128, 360])
def test_sample_heading(d):
    kj, kt = _keys(100, 9)
    want = np.asarray(jax.vmap(lambda k: jsampling.sample_heading(k, d))(kj))
    np.testing.assert_array_equal(sampling.sample_heading(kt, d).numpy(), want)


def test_units():
    from raycastworlds_tpu.ops import units as junits
    from raycastworlds_tpu_torch.ops import units

    r = np.random.default_rng(10)
    x = r.uniform(-3, 20, size=(50, 2)).astype(np.float32)
    d = r.uniform(-1, 1, size=(50, 2)).astype(np.float32)
    au = r.integers(0, 128, size=50).astype(np.int32)
    px = r.integers(0, 500, size=50).astype(np.int32)
    xt, dt, at = map(torch.from_numpy, (x, d, au))
    pairs = [
        (units.wu_to_tu(xt), junits.wu_to_tu(x)),
        (units.wu_to_pu(xt, 32), junits.wu_to_pu(x, 32)),
        (units.pu_to_tu(torch.from_numpy(px), 32), junits.pu_to_tu(px, 32)),
        (units.turn_left(at, 128), junits.turn_left(au, 128)),
        (units.turn_right(at, 128), junits.turn_right(au, 128)),
        (units.move_forward(xt, dt, 0.125), junits.move_forward(x, d, 0.125)),
        (units.move_backward(xt, dt, 0.125), junits.move_backward(x, d, 0.125)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
