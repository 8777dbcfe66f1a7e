"""The port's crossing casts vs the JAX package (exact).

* the plain cast (``ops/raycast.cast_rays_crossing``) against the JAX
  package's XLA ``cast_rays_crossing``;
* the kernel wrapper on CPU tensors (its plain version) against the JAX
  package's Pallas kernel in interpret mode;
* on a CUDA card, the CUDA kernel against its plain version.

The fuzz maps are those of tests/test_crossing.py: random walls at density
0.25 inside a border, random interior origins and directions.  XLA on the
CPU contracts ``p + t*d`` into an FMA where torch rounds twice; that can
flip an entered tile only where the cross coordinate lands exactly on a
grid line, which random inputs do not hit, so the JAX comparisons use
random directions plus exact-zero components (where ``t*0`` is exact).

The JAX package is imported inside the tests that compare with it, so that
the CUDA case also runs on a GPU machine without JAX:
``python -m pytest tests/test_torch_crossing.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from raycastworlds_tpu_torch.ops import raycast, raycast_crossing_kernel as rck
from raycastworlds_tpu_torch.ops.bitmap import pack_bits_np
from raycastworlds_tpu_torch.utils import profiling


# the "tiny" kind's ray components: t overflows to +inf partway along that axis
TINY = np.array([1e-30, 1e-37, 3e-38, 1e-39, 1e-44], np.float32)
AXES = np.array([[1, 0], [-1, 0], [0, 1], [0, -1]], np.float32)
_S = np.float32(np.sqrt(0.5))
DIAGONALS = np.array([[_S, _S], [_S, -_S], [-_S, _S], [-_S, -_S]], np.float32)


def fuzz_case(h, w, b, r, seed, diagonal=False, kind="random"):
    """(words u32[B, NW], pos f32[B, 2], dirs f32[B, R, 2]) on random maps,
    with a share of rays that have an exact-zero component (and, with
    ``diagonal``, exact 45-degree rays from integer positions, which sit on
    grid corners).  Other ``kind``s: "no_border", the same on maps without
    a border ring (rays leave the map and the clamped tile repeats);
    "sliding", integer positions and only axis-parallel rays; "corners",
    integer positions and only diagonal rays; "tiny", random rays with one
    component of magnitude in TINY."""
    rng = np.random.RandomState(seed)
    maps = []
    for _ in range(b):
        m = rng.rand(h, w) < 0.25
        if kind != "no_border":
            m[0, :] = m[-1, :] = True
            m[:, 0] = m[:, -1] = True
        maps.append(pack_bits_np(m))
    words = np.stack(maps)
    pos = rng.uniform([1.1, 1.1], [h - 1.1, w - 1.1], size=(b, 2)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, size=(b, r))
    dirs = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    if kind in ("sliding", "corners"):
        rays = AXES if kind == "sliding" else DIAGONALS
        return words, np.floor(pos), rays[rng.randint(0, 4, size=(b, r))]
    if kind == "tiny":
        comp = rng.randint(0, 2, size=(b, r, 1))
        tiny = TINY[rng.randint(0, len(TINY), size=(b, r, 1))] * rng.choice([-1, 1], (b, r, 1))
        np.put_along_axis(dirs, comp, tiny.astype(np.float32), axis=-1)
        return words, pos, dirs
    # gridline sliding: integer positions, axis-parallel rays
    nb = max(b // 4, 1)
    pos[:nb] = np.floor(pos[:nb])
    dirs[:nb, : min(r, 8)] = np.resize(AXES, (min(r, 8), 2))
    dirs[nb : 2 * nb, :4] = AXES[:r]  # axis-parallel from non-integer positions
    if diagonal:
        dirs[:nb, 8:12] = DIAGONALS[:max(r - 8, 0)]
    return words, pos, dirs


def _torch(words, pos, dirs, device="cpu"):
    return (
        torch.from_numpy(words.view(np.int32).copy()).to(device),
        torch.from_numpy(pos.copy()).to(device),
        torch.from_numpy(dirs.copy()).to(device),
    )


def _np(out):
    return [x.detach().cpu().numpy() for x in out]


SHAPES = [(8, 16), (13, 9), (24, 40), (48, 48)]


@pytest.mark.parametrize("h,w", SHAPES)
def test_plain_cast_matches_jax_crossing(h, w):
    import jax
    import jax.numpy as jnp
    from raycastworlds_tpu.ops import raycast as jraycast

    words, pos, dirs = fuzz_case(h, w, 8, 64, seed=0)
    want = jax.jit(jax.vmap(
        lambda ww, p, d: jraycast.cast_rays_crossing(ww, (h, w), p, d)
    ))(jnp.asarray(words), jnp.asarray(pos), jnp.asarray(dirs))
    wt, pt, dt = _torch(words, pos, dirs)
    got = raycast.cast_rays_crossing(wt, (h, w), pt, dt)
    for g, wnt in zip(_np(got), want):
        np.testing.assert_array_equal(g, np.asarray(wnt))


@pytest.mark.parametrize("h,w", SHAPES[:3])
def test_kernel_wrapper_cpu_matches_pallas_interpret(h, w):
    import jax
    import jax.numpy as jnp
    from raycastworlds_tpu.ops import raycast as jraycast
    from raycastworlds_tpu.ops import raycast_crossing_kernel as jrck

    words, pos, dirs = fuzz_case(h, w, 8, 64, seed=1)
    args = (jnp.asarray(words), jnp.asarray(pos), jnp.asarray(dirs))
    pallas = jrck.cast_rays_crossing_kernel(
        args[0], (h, w), *args[1:], interpret=True
    )
    xla = jax.jit(jax.vmap(
        lambda ww, p, d: jraycast.cast_rays_crossing(ww, (h, w), p, d)
    ))(*args)
    wt, pt, dt = _torch(words, pos, dirs)
    before = profiling.total("kernel_launches.crossing_cast")
    got = _np(rck.cast_rays_crossing_kernel(wt, (h, w), pt, dt))
    assert profiling.total("kernel_launches.crossing_cast") == before  # CPU: no launch
    for want in (pallas, xla):
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(wnt))


@pytest.mark.parametrize("h,w", SHAPES)
def test_kernel_ref_matches_plain_cast(h, w):
    """Both port versions round identically, so they agree even on rays
    through grid corners."""
    words, pos, dirs = fuzz_case(h, w, 5, 37, seed=2, diagonal=True)
    wt, pt, dt = _torch(words, pos, dirs)
    a = raycast.cast_rays_crossing(wt, (h, w), pt, dt)
    b = rck.cast_rays_crossing_kernel_ref(wt, (h, w), pt, dt)
    for x, y in zip(_np(a), _np(b)):
        np.testing.assert_array_equal(x, y)


def test_wrapper_rejects_bad_inputs():
    words, pos, dirs = fuzz_case(8, 16, 2, 4, seed=3)
    wt, pt, dt = _torch(words, pos, dirs)
    with pytest.raises(TypeError):
        rck.cast_rays_crossing_kernel(wt.to(torch.int64), (8, 16), pt, dt)
    with pytest.raises(TypeError):
        rck.cast_rays_crossing_kernel(wt, (8, 16), pt.double(), dt)
    with pytest.raises(ValueError):
        rck.cast_rays_crossing_kernel(wt, (9, 16), pt, dt)
    with pytest.raises(ValueError):
        rck.cast_rays_crossing_kernel(wt, (8, 16), pt[:1], dt)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


# The card's cases: the four fuzz maps; sliding rays; 1 and 80 rays per env
# and a 336x336 map at 2 rays (the kernel's block layouts: 4 envs' words
# of the big map exceed shared memory, so a block takes 2); and the inputs
# an early-exit walk has to survive at the main paths' maps.
CUDA_CASES = [
    (8, 16, 64, 512, "random"), (13, 9, 7, 100, "random"), (24, 40, 16, 129, "random"),
    (48, 48, 8, 256, "random"), (8, 16, 64, 512, "sliding"), (24, 40, 16, 333, "sliding"),
    (8, 16, 256, 1, "random"), (8, 16, 256, 80, "random"), (336, 336, 64, 2, "random"),
] + [(h, w, 64, r, kind) for kind in ("no_border", "tiny", "corners")
     for h, w, r in ((8, 16, 512), (16, 16, 256), (17, 17, 64), (24, 40, 333))]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,b,r,kind", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda_device, h, w, b, r, kind):
    words, pos, dirs = fuzz_case(h, w, b, r, seed=4, diagonal=True, kind=kind)
    args = _torch(words, pos, dirs, cuda_device)
    before = profiling.total("kernel_launches.crossing_cast")
    got = rck.cast_rays_crossing_kernel(args[0], (h, w), *args[1:])
    torch.cuda.synchronize()
    assert profiling.total("kernel_launches.crossing_cast") == before + 1
    want = rck.cast_rays_crossing_kernel_ref(args[0], (h, w), *args[1:])
    for g, wnt in zip(_np(got), _np(want)):
        np.testing.assert_array_equal(g, wnt)
