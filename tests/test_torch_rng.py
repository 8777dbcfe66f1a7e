"""The port's threefry draws equal jax.random's bit for bit (exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raycastworlds_tpu_torch import rng

SEEDS = np.random.default_rng(0).integers(-(2**31), 2**31, size=200)


def _keys_jax():
    return jax.vmap(jax.random.PRNGKey)(jnp.asarray(SEEDS, jnp.int32))


def _keys_torch():
    return torch.stack([rng.PRNGKey(int(s)) for s in SEEDS])


def test_prng_key():
    np.testing.assert_array_equal(
        np.asarray(_keys_jax()), _keys_torch().numpy().astype(np.uint32)
    )
    for s in (0, 1, 42, 2**31 - 1, -1, -(2**31)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.PRNGKey(s)),
            rng.PRNGKey(s).numpy().astype(np.uint32),
        )


@pytest.mark.parametrize("num", [1, 2, 4, 7, 64])
def test_split(num):
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(_keys_jax()))
    got = rng.split(_keys_torch(), num).numpy().astype(np.uint32)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("shape", [(), (2,), (3, 5), (16,)])
def test_uniform(shape):
    want = np.asarray(
        jax.vmap(lambda k: jax.random.uniform(k, shape, jnp.float32))(_keys_jax())
    )
    got = rng.uniform(_keys_torch(), shape).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize(
    "shape,lo,hi",
    [
        ((), 0, 128),
        ((), 0, 4),
        ((), 0, 7),
        ((), 5, 5),          # empty span returns minval
        ((), -3, 1000003),
        ((9,), 0, 4),
        ((4, 3), -10, 10),
        ((2,), [1, 1], [7, 15]),    # the goal draw's array bounds
        ((2,), [1, 1], [46, 23]),
    ],
)
def test_randint(shape, lo, hi):
    want = np.asarray(
        jax.vmap(
            lambda k: jax.random.randint(
                k, shape, jnp.asarray(lo), jnp.asarray(hi), dtype=jnp.int32
            )
        )(_keys_jax())
    )
    got = rng.randint(_keys_torch(), shape, lo, hi).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(want, got)


def test_unbatched_key():
    """A single [2] key draws what jax.random draws for it."""
    k = jax.random.PRNGKey(3)
    kt = rng.PRNGKey(3)
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(k, (5, 6), 0, 4, dtype=jnp.int32)),
        rng.randint(kt, (5, 6), 0, 4).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jax.random.split(k)), rng.split(kt).numpy().astype(np.uint32)
    )


@pytest.mark.parametrize("n", [1, 2, 7, 32, 1000, 4097])
def test_permutation(n):
    """rng.permutation equals jax.random.permutation exactly (one sort round
    up to n = 1625, two beyond)."""
    for k in (_keys_jax()[:8]):
        want = np.asarray(jax.random.permutation(k, n))
        got = rng.permutation(torch.from_numpy(np.asarray(k).astype(np.int64)), n)
        np.testing.assert_array_equal(want, got.numpy())


def test_categorical():
    """rng.categorical draws jax.random.categorical's actions.  The uniform
    bits are exact and log may differ by an ulp, so an action may differ
    only at a near tie: the top two Gumbel-perturbed scores within 1e-5."""
    logits = np.random.default_rng(0).normal(size=(64, 33, 4)).astype(np.float32)
    want = np.asarray(jax.vmap(jax.random.categorical)(_keys_jax()[:64],
                                                       jnp.asarray(logits)))
    got = torch.stack([
        rng.categorical(k, torch.from_numpy(lg))
        for k, lg in zip(_keys_torch()[:64], logits)
    ]).numpy()
    assert got.dtype == np.int32
    differ = np.argwhere(got != want)
    for i, j in differ:
        u = rng.uniform(_keys_torch()[i], (33, 4), minval=float(np.finfo(np.float32).tiny))
        score = np.sort((-torch.log(-torch.log(u))).numpy()[j] + logits[i, j])
        assert score[-1] - score[-2] < 1e-5, (i, j, score)
    assert len(differ) <= 2, differ


@pytest.mark.parametrize("data", [0, 1, 2**31, 2**32 - 1])
def test_fold_in(data):
    want = np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, data))(_keys_jax()))
    got = rng.fold_in(_keys_torch(), data).numpy().astype(np.uint32)
    np.testing.assert_array_equal(want, got)
    # one key, as the rollout demo folds its chunk key
    np.testing.assert_array_equal(
        np.asarray(jax.random.fold_in(jax.random.PRNGKey(1), data)),
        rng.fold_in(rng.PRNGKey(1), data).numpy().astype(np.uint32))
