"""The crossing kernel's early-exit walk (``csrc/crossing.cuh``), emulated
ray by ray in numpy float32, against the full-loop plain version
``cast_rays_crossing_kernel_ref`` and the JAX package's Pallas kernel in
interpret mode (exact on every output).

The emulation follows the kernel's control flow: the j axis is walked
first and stops at its first occupied crossing; the i axis is walked only
while its crossing distance is below j's; an axis whose direction
component is zero is skipped; a walk stops where its distance reaches
FLT_MAX (overflow to +inf included).  It is exact against the full loop
because the crossing distance t_k = (frac + k) / |d| never decreases in k,
which the last test checks.

Inputs from numpy seeds: density-0.25 maps with and without a border ring,
random and axis-parallel rays, diagonal rays from tile corners, rays with a
tiny component, and an odd ray count.  XLA on the CPU flushes subnormals to
zero, so the JAX comparison takes the normal tiny magnitudes only.
"""

import numpy as np
import pytest
import torch

from raycastworlds_tpu_torch.ops import raycast_crossing_kernel as rck
from raycastworlds_tpu_torch.ops.bitmap import pack_bits_np

F32_MAX = np.float32(np.finfo(np.float32).max)
ONE = np.float32(1.0)
ZERO = np.float32(0.0)
NORMAL_TINY = np.array([1e-30, 1e-37, 3e-38], np.float32)
SUBNORMAL_TINY = np.array([1e-39, 1e-44], np.float32)


def axis_walk(occ, d_main, d_cross, p_main, p_cross, n, size_cross, w, main_is_i,
              t_stop):
    """One axis of the kernel's walk: (t, entered main tile, cross tile,
    candidates looked at)."""
    fl = np.floor(p_main)
    main0 = int(fl)
    step = -1 if d_main < ZERO else 1
    frac = p_main - fl
    frac_sel = frac if d_main < ZERO else ONE - frac
    ad = np.abs(d_main)
    c_max = np.float32(size_cross - 1)
    seen = 0
    if ad > ZERO:
        for k in range(n):
            t = (frac_sel + np.float32(k)) / ad
            if not t < t_stop:
                break
            seen += 1
            c = p_cross + t * d_cross
            if main_is_i:
                c_tile = np.floor(c) if d_cross >= ZERO else np.ceil(c) - ONE
            else:
                c_tile = np.ceil(c) - ONE if d_cross > ZERO else np.floor(c)
            c_idx = int(np.fmin(np.fmax(c_tile, ZERO), c_max))
            m = min(max(main0 + (k + 1) * step, 0), n - 1)
            if occ[m * w + c_idx if main_is_i else c_idx * w + m]:
                return t, main0 + (k + 1) * step, c_idx, seen
    return F32_MAX, main0 + step, 0, seen


def walk_cast(maps, pos, dirs):
    """The kernel's cast of every ray: (hit_tu, hit_dim, dist, candidates
    looked at in all)."""
    b, h, w = maps.shape
    r = dirs.shape[1]
    hit_tu = np.zeros((b, r, 2), np.int32)
    hit_dim = np.zeros((b, r), np.int32)
    dist = np.zeros((b, r), np.float32)
    seen = 0
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        for e in range(b):
            occ = maps[e].reshape(-1)
            px, py = pos[e]
            for q in range(r):
                dx, dy = dirs[e, q]
                tj, jj, ij, sj = axis_walk(occ, dy, dx, py, px, w, h, w, False, F32_MAX)
                ti, ii, ji, si = axis_walk(occ, dx, dy, px, py, h, w, w, True, tj)
                seen += sj + si
                if tj <= ti:
                    hit_tu[e, q], hit_dim[e, q], dist[e, q] = (ij, jj), 1, tj
                else:
                    hit_tu[e, q], hit_dim[e, q], dist[e, q] = (ii, ji), 0, ti
    return hit_tu, hit_dim, dist, seen


def walk_case(h, w, b, r, seed, tiny):
    """Maps (border ring on the first half of the envs only), positions and
    rays: random rays; integer positions with diagonal rays (tile corners)
    on a quarter of the envs; axis-parallel rays and rays with a ``tiny``
    component on every env."""
    rng = np.random.default_rng(seed)
    maps = rng.random((b, h, w)) < 0.25
    maps[: b // 2, [0, -1], :] = True
    maps[: b // 2, :, [0, -1]] = True
    pos = rng.uniform([1.0, 1.0], [h - 1.0, w - 1.0], size=(b, 2)).astype(np.float32)
    ang = rng.uniform(0.0, 2.0 * np.pi, size=(b, r))
    dirs = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    s = np.float32(np.sqrt(0.5))
    corners = rng.choice(b, size=b // 4, replace=False)
    pos[corners] = np.floor(pos[corners])
    dirs[corners, :12] = np.resize(np.array([[s, s], [-s, s], [-s, -s], [s, -s]],
                                            np.float32), (12, 2))
    dirs[:, 12:16] = np.array([[1, 0], [-1, 0], [0, 1], [0, -1]], np.float32)
    comp = rng.integers(0, 2, size=(b, 8))
    mag = tiny[rng.integers(0, len(tiny), size=(b, 8))]
    sign = rng.choice(np.array([-1, 1], np.float32), size=(b, 8))
    rows = np.arange(b)[:, None]
    dirs[rows, 16 + np.arange(8), comp] = mag * sign
    return maps, pos, dirs


def _ref(maps, pos, dirs):
    h, w = maps.shape[1:]
    words = torch.from_numpy(pack_bits_np(maps).view(np.int32))
    out = rck.cast_rays_crossing_kernel_ref(
        words, (h, w), torch.from_numpy(pos), torch.from_numpy(dirs))
    return [x.numpy() for x in out]


@pytest.mark.parametrize("h,w", [(8, 16), (17, 17), (24, 40)])
def test_walk_matches_full_loop(h, w):
    maps, pos, dirs = walk_case(h, w, 8, 33, seed=h * w,
                                tiny=np.concatenate([NORMAL_TINY, SUBNORMAL_TINY]))
    *got, seen = walk_cast(maps, pos, dirs)
    for g, want in zip(got, _ref(maps, pos, dirs)):
        np.testing.assert_array_equal(g, want)
    # the walk looks at fewer candidates than the full loop's H + W a ray
    assert seen < 0.6 * (h + w) * dirs.shape[0] * dirs.shape[1]


def test_walk_matches_jax_pallas_interpret():
    import jax.numpy as jnp
    from raycastworlds_tpu.ops import raycast_crossing_kernel as jrck

    maps, pos, dirs = walk_case(17, 17, 8, 65, seed=7, tiny=NORMAL_TINY)
    *got, _ = walk_cast(maps, pos, dirs)
    want = jrck.cast_rays_crossing_kernel(
        jnp.asarray(pack_bits_np(maps)), (17, 17), jnp.asarray(pos), jnp.asarray(dirs),
        interpret=True)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(wnt))


@pytest.mark.parametrize("seed", range(4))
def test_crossing_distance_never_decreases_in_k(seed):
    """t_k = (frac_sel + k) / ad in float32 for frac_sel in [0, 1], ad in
    (0, 1] and every k < 64 (frac_sel 0 and 1 and ad 1 included)."""
    rng = np.random.default_rng(seed)
    frac_sel = rng.uniform(0.0, 1.0, size=4096).astype(np.float32)
    frac_sel[:2] = (0.0, 1.0)
    ad = (1.0 - rng.uniform(0.0, 1.0, size=4096)).astype(np.float32)  # (0, 1]
    ad[2] = 1.0
    k = np.arange(64, dtype=np.float32)
    t = (frac_sel[:, None] + k[None, :]) / ad[:, None]
    assert t.dtype == np.float32
    assert (np.diff(t, axis=1) >= 0).all()
