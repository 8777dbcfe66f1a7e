"""The DDA kernel's wrapper (``ops/raycast_pallas.cast_rays_pallas_batched``)
vs the JAX package (exact).

* On CPU tensors the wrapper runs its plain version, the scan, and launches
  nothing; it is held against the JAX package's Pallas kernel in interpret
  mode and against the JAX scan.  The Pallas comparison uses rays with no
  exact-zero component: there the JAX kernel's ``side + go * delta`` is
  ``0 * inf = NaN`` (tests/test_torch_fused_render.py shows the fault).
* On a CUDA card, the CUDA kernel against its plain version:
  ``python -m pytest tests/test_torch_dda_kernel.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from raycastworlds_tpu_torch.ops import raycast, raycast_pallas
from raycastworlds_tpu_torch.utils import profiling
from test_torch_crossing import CUDA_CASES, SHAPES, _np, _torch, fuzz_case


def no_zero_case(h, w, b, r, seed):
    """Random maps, positions and directions with both components nonzero
    (45-degree rays from integer positions included)."""
    words, pos, dirs = fuzz_case(h, w, b, r, seed, diagonal=True)
    zero = (dirs == 0).any(axis=-1)
    ang = np.random.RandomState(seed + 1).uniform(0.1, 1.4, size=int(zero.sum()))
    dirs[zero] = np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)
    assert (dirs != 0).all()
    return words, pos, dirs


def _jax_pallas(words, pos, dirs, shape, steps):
    import jax.numpy as jnp
    from raycastworlds_tpu.ops import raycast_pallas as jrp

    out = jrp.cast_rays_pallas_batched(
        jnp.asarray(words), shape, jnp.asarray(pos), jnp.asarray(dirs), steps,
        block_envs=8,
    )
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("h,w", SHAPES)
def test_wrapper_cpu_matches_pallas_interpret(h, w):
    words, pos, dirs = no_zero_case(h, w, 8, 64, seed=20)
    want = _jax_pallas(words, pos, dirs, (h, w), h + w)
    wt, pt, dt = _torch(words, pos, dirs)
    before = profiling.total("kernel_launches.dda_cast")
    got = _np(raycast_pallas.cast_rays_pallas_batched(wt, (h, w), pt, dt, h + w))
    assert profiling.total("kernel_launches.dda_cast") == before  # CPU: no launch
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g, wnt)


@pytest.mark.parametrize("steps", [1, 3])
def test_wrapper_truncated_matches_pallas_interpret(steps):
    words, pos, dirs = no_zero_case(8, 16, 8, 33, seed=21)
    want = _jax_pallas(words, pos, dirs, (8, 16), steps)
    wt, pt, dt = _torch(words, pos, dirs)
    got = _np(raycast_pallas.cast_rays_pallas_batched(wt, (8, 16), pt, dt, steps))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g, wnt)


def test_wrapper_cpu_matches_jax_scan_on_every_input():
    import jax
    import jax.numpy as jnp
    from raycastworlds_tpu.ops import raycast as jraycast

    words, pos, dirs = fuzz_case(24, 40, 8, 64, seed=22, diagonal=True)
    want = jax.jit(jax.vmap(
        lambda ww, p, d: jraycast.cast_rays_scan(ww, (24, 40), p, d, 64)
    ))(jnp.asarray(words), jnp.asarray(pos), jnp.asarray(dirs))
    wt, pt, dt = _torch(words, pos, dirs)
    got = _np(raycast_pallas.cast_rays_pallas_batched(wt, (24, 40), pt, dt, 64))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(wnt))


def test_wrapper_rejects_bad_inputs():
    words, pos, dirs = fuzz_case(8, 16, 2, 4, seed=23)
    wt, pt, dt = _torch(words, pos, dirs)
    cast = raycast_pallas.cast_rays_pallas_batched
    with pytest.raises(TypeError):
        cast(wt.to(torch.int64), (8, 16), pt, dt, 24)
    with pytest.raises(TypeError):
        cast(wt, (8, 16), pt, dt.double(), 24)
    with pytest.raises(ValueError):
        cast(wt, (9, 16), pt, dt, 24)
    with pytest.raises(ValueError):
        cast(wt, (8, 16), pt, dt[:1], 24)
    with pytest.raises(ValueError):
        cast(wt, (8, 16), pt, dt, -1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "h,w,b,r,kind,steps",
    [(h, w, b, r, kind, h + w) for h, w, b, r, kind in CUDA_CASES]
    + [(8, 16, 33, 65, "random", 3), (24, 40, 16, 333, "sliding", 3)],
)
def test_cuda_kernel_matches_plain(cuda_device, h, w, b, r, kind, steps):
    words, pos, dirs = fuzz_case(h, w, b, r, seed=24, diagonal=True, kind=kind)
    args = _torch(words, pos, dirs, cuda_device)
    before = profiling.total("kernel_launches.dda_cast")
    got = raycast_pallas.cast_rays_pallas_batched(args[0], (h, w), *args[1:], steps)
    torch.cuda.synchronize()
    assert profiling.total("kernel_launches.dda_cast") == before + 1
    want = raycast.cast_rays_scan(args[0], (h, w), *args[1:], steps)
    for g, wnt in zip(_np(got), _np(want)):
        np.testing.assert_array_equal(g, wnt)
