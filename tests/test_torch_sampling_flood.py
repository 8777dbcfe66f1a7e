"""The port's random draws, masked samplers, packing helpers and flood fill
against the JAX package, exact, on numpy-seeded inputs.

Keys are random uint32 pairs; maps are random occupancy at several sizes,
including 48x48 (2304 tiles, past the JAX prefix count's 256-tile block),
an all-occupied map (tile 0 by convention) and a map with one empty tile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu.ops import bitmap as jbitmap
from raycastworlds_tpu.ops import flood as jflood
from raycastworlds_tpu.ops import sampling as jsampling
from raycastworlds_tpu_torch.ops import bitmap, flood, sampling


def _keys(n, seed):
    k = np.random.default_rng(seed).integers(0, 2**32, size=(n, 2), dtype=np.uint64)
    return jnp.asarray(k.astype(np.uint32)), torch.from_numpy(k.astype(np.int64))


def _maps(b, h, w, density, seed):
    occ = np.random.default_rng(seed).random((b, h, w)) < density
    occ[0] = True                      # all occupied
    occ[1] = True
    occ[1, h // 2, w // 3] = False     # a single empty tile
    return occ


def test_bernoulli_matches_jax():
    jk, tk = _keys(6, 0)
    for p in (0.5, 0.2, 0.9):
        want = jax.vmap(lambda k: jax.random.bernoulli(k, p, (9, 7)))(jk)
        np.testing.assert_array_equal(rt.rng.bernoulli(tk, p, (9, 7)).numpy(), np.asarray(want))


def test_bernoulli_compares_in_float32():
    """A density just above a drawn uniform in float64 rounds to it in
    float32, so the draw is False in both packages."""
    jk, tk = _keys(1, 1)
    u = rt.rng.uniform(tk, (64,))[0]
    i = int(torch.argmax((u > 0.25).to(torch.int32)))
    p = float(u[i]) + 1e-12
    assert np.float32(p) == u[i].item() and p > u[i].item()
    got = rt.rng.bernoulli(tk, p, (64,))[0].numpy()
    want = np.asarray(jax.random.bernoulli(jk[0], p, (64,)))
    np.testing.assert_array_equal(got, want)
    assert not got[i]
    # through a RandomRoom reset, whose interior walls are this draw
    kw = dict(height_tile_map_tu=8, width_tile_map_tu=8, wall_density=p,
              num_rays=8, height_camera_view_pu=8)
    js = jax.vmap(rcw.RandomRoom(rcw.RandomRoomConfig(**kw)).reset_single)(jk)
    ts = rt.RandomRoom(rt.RandomRoomConfig(**kw)).reset_batch(tk)
    np.testing.assert_array_equal(ts.to_numpy()["wall_words"], np.asarray(js.wall_words))


@pytest.mark.parametrize("hw,density", [((9, 9), 0.3), ((5, 7), 0.8), ((48, 48), 0.4)])
def test_sample_empty_tile_and_pair(hw, density):
    h, w = hw
    occ = _maps(12, h, w, density, seed=h)
    jk, tk = _keys(12, h)
    jk2, tk2 = _keys(12, h + 100)
    to = torch.from_numpy(occ)
    want = jax.vmap(jsampling.sample_empty_tile)(jk, jnp.asarray(occ))
    np.testing.assert_array_equal(sampling.sample_empty_tile(tk, to).numpy(), np.asarray(want))
    assert np.asarray(want)[0].tolist() == [0, 0]
    wa, wb = jax.vmap(jsampling.sample_empty_tile_pair)(jk, jk2, jnp.asarray(occ))
    ga, gb = sampling.sample_empty_tile_pair(tk, tk2, to)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    # the prefix count itself, blocked matvecs in JAX against a cumsum
    flat = (~occ).reshape(12, -1)
    want_c = jax.vmap(jsampling._prefix_count)(jnp.asarray(flat, jnp.float32))
    np.testing.assert_array_equal(
        sampling._prefix_count(torch.from_numpy(flat)).numpy(), np.asarray(want_c))


@pytest.mark.parametrize("kx", [0, 1, 4])
def test_sample_empty_interior_tile(kx):
    h, w, b = 8, 11, 32
    jk, tk = _keys(b, 10 + kx)
    r = np.random.default_rng(kx)
    # distinct ranks, unsorted
    ranks = np.stack([r.permutation((h - 2) * (w - 2))[:kx] for _ in range(b)]).astype(np.int32)
    want = jax.vmap(lambda k, e: jsampling.sample_empty_interior_tile(k, h, w, e))(
        jk, jnp.asarray(ranks.reshape(b, kx)))
    got = sampling.sample_empty_interior_tile(tk, h, w, torch.from_numpy(ranks.reshape(b, kx)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tiles_to_words_and_popcount():
    h, w, b, k = 9, 13, 10, 5
    r = np.random.default_rng(3)
    tiles = np.stack([r.integers(0, h, size=(b, k)), r.integers(0, w, size=(b, k))],
                     axis=-1).astype(np.int32)
    tiles[r.random((b, k)) < 0.3] = -1            # disabled slots
    nw = jbitmap.n_words(h * w)
    want = jax.vmap(lambda t: jbitmap.tiles_to_words(t, (h, w), nw))(jnp.asarray(tiles))
    got = bitmap.tiles_to_words(torch.from_numpy(tiles), (h, w), nw)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    words = r.integers(0, 2**32, size=(64,), dtype=np.uint64).astype(np.uint32)
    words[:3] = [0, 0xFFFFFFFF, 0x80000000]
    np.testing.assert_array_equal(
        bitmap.popcount(torch.from_numpy(words.view(np.int32))).numpy(),
        np.asarray(jax.lax.population_count(jnp.asarray(words))).astype(np.int32))


@pytest.mark.parametrize("iters", [None, 3])
@pytest.mark.parametrize("hw", [(10, 10), (7, 13)])
def test_flood_fill(hw, iters):
    h, w = hw
    b = 16
    r = np.random.default_rng(h * w)
    passable = r.random((b, h, w)) < 0.65
    seed = np.stack([r.integers(0, h, size=b), r.integers(0, w, size=b)], -1).astype(np.int32)
    want = jax.vmap(lambda p, s: jflood.flood_fill(p, s, iters))(
        jnp.asarray(passable), jnp.asarray(seed))
    got = flood.flood_fill(torch.from_numpy(passable), torch.from_numpy(seed), iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if iters is None:  # the full fill reaches more than three dilations
        short = flood.flood_fill(torch.from_numpy(passable), torch.from_numpy(seed), 3)
        assert int(got.sum()) > int(short.sum())
