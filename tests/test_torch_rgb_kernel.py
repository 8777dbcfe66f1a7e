"""The RGB conversion's CUDA kernel (``csrc/u32_to_rgb.cu``) and its
dispatch in ``raycastworlds_tpu_torch.ops.render``.

* On the CPU: a CPU frame takes the plain path, ``u32_to_rgb_plain``, and
  never reaches ``cuda_build``; the plain path equals the host's
  ``colors.u32_to_rgb`` and the JAX package's ``u32_to_rgb`` on random
  32-bit values with the top byte set.  The wrapper, launching an
  emulation of the kernel (numpy over the launch's raw pointers: whole
  groups of 16 pixels packed by ``__byte_perm`` with the selectors read
  from the source where input and output are 16 B-aligned, the rest one
  pixel at a time), equals the plain path in one launch on every pixel
  count 1-47, [1, 1, 1], frame shapes of the paths, int32 and uint32
  views, an input whose base is not 16 B-aligned and a non-contiguous
  input; an empty frame launches nothing; other dtypes raise.
* On a CUDA card, the same cases and the RandomRoom benchmark cell's
  [8192, 128, 256] frames: kernel == plain on the card == the CPU, bit
  for bit, one ``kernel_launches.u32_to_rgb`` a call, a contiguous uint8
  [..., 3] output:
  ``python -m pytest tests/test_torch_rgb_kernel.py -m cuda --noconftest``.

Only the CPU comparison with the JAX package imports JAX, inside its test:
the card machine has none.
"""

import ctypes
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

from raycastworlds_tpu_torch import colors, cuda_build
from raycastworlds_tpu_torch.ops import render
from raycastworlds_tpu_torch.utils import profiling

SOURCE = os.path.join(os.path.dirname(cuda_build.__file__), "csrc", "u32_to_rgb.cu")


def _source():
    with open(SOURCE) as f:
        return f.read()


PIXELS_PER_THREAD = int(re.search(r"constexpr int kPixelsPerThread = (\d+);",
                                  _source()).group(1))
# pack4's three words w0, w1, w2: (first pixel, second pixel, selector)
PACK = [(int(a), int(b), int(s, 16)) for a, b, s in re.findall(
    r"w\d = __byte_perm\(p(\d), p(\d), (0x[0-9a-fA-F]+)\);", _source())]

# the paths' frames: RandomRoom camera_rgb, SingleRoom top_rgb (8 px a
# tile), a MultiPlayerRoom batch of 2 players' views
SHAPES = [(8, 128, 256), (4, 64, 128), (2, 2, 64, 64), (1, 1, 1), (3, 5, 7)]


def _frames(shape, seed=0):
    """int32 frames of random 32-bit values, the top byte set too."""
    n = int(np.prod(shape))
    u = np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint64)
    return torch.from_numpy(u.astype(np.uint32).view(np.int32).reshape(shape))


def _variants(img):
    """name -> the frame as each input the kernel takes: int32, its uint32
    view, a view whose base is 4 B past a 16 B boundary, a transpose."""
    flat = torch.cat([img.reshape(-1)[:1], img.reshape(-1)])
    return {
        "int32": img,
        "uint32": img.view(torch.uint32),
        "misaligned": flat[1:].view(img.shape),
        "non_contiguous": img.transpose(0, -1),
    }


# -- the plain path on the CPU --------------------------------------------

def _never(*args, **kwargs):
    raise AssertionError("a CPU frame reached cuda_build")


@pytest.mark.parametrize("shape", SHAPES)
def test_cpu_frame_never_reaches_cuda_build(monkeypatch, shape):
    monkeypatch.setattr(cuda_build, "load", _never)
    monkeypatch.setattr(cuda_build, "launch", _never)
    img = _frames(shape)
    before = profiling.total("kernel_launches.u32_to_rgb")
    for x in _variants(img).values():
        got = render.u32_to_rgb(x)
        assert got.device.type == "cpu" and torch.equal(got, render.u32_to_rgb_plain(x))
    assert profiling.total("kernel_launches.u32_to_rgb") == before


def test_plain_equals_host_and_jax():
    """Random 32-bit values (the top byte set on most) against
    ``colors.u32_to_rgb`` and the JAX package's ``u32_to_rgb``."""
    import jax.numpy as jnp

    from raycastworlds_tpu.ops import render as jrender

    img = _frames((4, 33, 17), seed=3)
    u = img.numpy().view(np.uint32)
    assert (u >> 24).any()
    got = render.u32_to_rgb(img).numpy()
    np.testing.assert_array_equal(got, colors.u32_to_rgb(u))
    np.testing.assert_array_equal(got, np.asarray(jrender.u32_to_rgb(jnp.asarray(u))))
    np.testing.assert_array_equal(render.u32_to_rgb(img.view(torch.uint32)).numpy(), got)


# -- the wrapper on the CPU, launching an emulation of the kernel ---------

def _array(ctype, address, n):
    return np.ctypeslib.as_array((ctype * n).from_address(address))


def _byte_perm(x, y, s):
    """CUDA's ``__byte_perm``: byte k of the result is byte ``(s >> 4k) &
    7`` of the eight bytes x (0-3), y (4-7)."""
    pool = [(v >> np.uint32(8 * k)) & np.uint32(0xFF) for v in (x, y) for k in range(4)]
    out = np.zeros_like(x)
    for k in range(4):
        out |= pool[(s >> (4 * k)) & 7] << np.uint32(8 * k)
    return out


def _emulated_kernel(in_ptr, out_ptr, n):
    """``rcw_u32_to_rgb`` on host memory: the C entry's arguments (without
    the stream), read, computed and written as the kernel does."""
    assert n >= 1 and len(PACK) == 3
    src = _array(ctypes.c_uint32, in_ptr, n)
    dst = _array(ctypes.c_uint8, out_ptr, 3 * n)
    groups = n // PIXELS_PER_THREAD if in_ptr % 16 == 0 and out_ptr % 16 == 0 else 0
    whole = groups * PIXELS_PER_THREAD
    quads = src[:whole].reshape(-1, 4)
    words = np.stack([_byte_perm(quads[:, a], quads[:, b], s) for a, b, s in PACK], -1)
    dst[:3 * whole] = words.astype("<u4").view(np.uint8).reshape(-1)
    tail, out = src[whole:], dst[3 * whole:].reshape(-1, 3)
    for c, shift in enumerate((16, 8, 0)):
        out[:, c] = (tail >> np.uint32(shift)) & np.uint32(0xFF)


def _through_emulation(monkeypatch, fn):
    """``fn()`` with the conversion dispatched as for a CUDA frame, the
    kernel's launch going to the emulation; (result, launches made)."""
    launches = []

    def launch(entry, device, *args, what):
        assert entry is _emulated_kernel and what == "RGB conversion" and device.type == "cpu"
        launches.append(args)
        entry(*args)

    with monkeypatch.context() as m:
        m.setattr(render, "_uses_kernel", lambda img: True)
        m.setattr(cuda_build, "load",
                  lambda: types.SimpleNamespace(rcw_u32_to_rgb=_emulated_kernel))
        m.setattr(cuda_build, "launch", launch)
        return fn(), launches


def _emulation_matches(monkeypatch, x, aligned):
    want = render.u32_to_rgb_plain(x)
    got, launches = _through_emulation(monkeypatch, lambda: render.u32_to_rgb(x))
    assert len(launches) == 1
    in_ptr, out_ptr, n = launches[0]
    assert n == x.numel() and (in_ptr % 16 == 0) == aligned
    assert got.dtype == torch.uint8 and got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", range(1, 48))
def test_wrapper_equals_plain_every_tail(monkeypatch, n):
    """Pixel counts 1-47: no whole group, then one and two groups with
    every tail, aligned and not."""
    for name, x in _variants(_frames((n,), seed=n)).items():
        if name != "non_contiguous":
            _emulation_matches(monkeypatch, x, name != "misaligned")


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_equals_plain(monkeypatch, shape):
    for name, x in _variants(_frames(shape)).items():
        # a non-contiguous frame is copied first, to a fresh allocation
        _emulation_matches(monkeypatch, x, name != "misaligned")


def test_cases_reach_both_loops(monkeypatch):
    """[8, 128, 256] runs every pixel through the vector loop (the
    emulated packing differs from a mere shift if a selector is wrong) and
    the misaligned view every pixel through the scalar loop."""
    img = _frames((8, 128, 256))
    assert img.numel() % PIXELS_PER_THREAD == 0 and len(PACK) == 3
    misaligned = _variants(img)["misaligned"]
    with monkeypatch.context() as m:
        m.setattr(sys.modules[__name__], "PACK", [(a, b, s ^ 0x1) for a, b, s in PACK])
        got, _ = _through_emulation(monkeypatch, lambda: render.u32_to_rgb(img))
        scalar, _ = _through_emulation(monkeypatch, lambda: render.u32_to_rgb(misaligned))
    assert not torch.equal(got, render.u32_to_rgb_plain(img))
    assert torch.equal(scalar, render.u32_to_rgb_plain(misaligned))


@pytest.mark.parametrize("dtype", [torch.int64, torch.int16, torch.float32, torch.uint8])
def test_wrapper_refuses_other_dtypes(monkeypatch, dtype):
    x = torch.zeros(4, 4, dtype=dtype)
    with pytest.raises(ValueError, match="int32 or uint32"):
        _through_emulation(monkeypatch, lambda: render.u32_to_rgb(x))


def test_empty_frame_launches_nothing(monkeypatch):
    x = torch.zeros(0, 7, 9, dtype=torch.int32)
    got, launches = _through_emulation(monkeypatch, lambda: render.u32_to_rgb(x))
    assert launches == [] and tuple(got.shape) == (0, 7, 9, 3) and got.dtype == torch.uint8


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _launches():
    return profiling.total("kernel_launches.u32_to_rgb")


def _card_matches(x, device, want=None):
    """The kernel on ``x`` (on ``device``) == the plain path on the card ==
    ``want`` (the CPU's, when given), in one launch."""
    before = _launches()
    got = render.u32_to_rgb(x)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.uint8 and got.is_contiguous()
    assert tuple(got.shape) == tuple(x.shape) + (3,)
    assert torch.equal(got, render.u32_to_rgb_plain(x))
    if want is not None:
        assert torch.equal(got.cpu(), want)


def _card_variants(img, device):
    """``_variants`` of ``img`` moved to the card (the misaligned one
    sliced there, from a fresh allocation)."""
    out = _variants(img.to(device))
    assert out["misaligned"].data_ptr() % 16 == 4
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_matches_plain(cuda_device, shape):
    img = _frames(shape)
    for x, y in zip(_variants(img).values(), _card_variants(img, cuda_device).values()):
        _card_matches(y, cuda_device, render.u32_to_rgb_plain(x))


@pytest.mark.cuda
def test_cuda_kernel_every_tail(cuda_device):
    """Pixel counts 1-47, each as every variant but the transpose."""
    for n in range(1, 48):
        img = _frames((n,), seed=n)
        want = render.u32_to_rgb_plain(img)
        for name, y in _card_variants(img, cuda_device).items():
            if name != "non_contiguous":
                _card_matches(y, cuda_device, want)


@pytest.mark.cuda
def test_cuda_kernel_at_the_cells_shape(cuda_device):
    """[8192, 128, 256], RandomRoom's frames in the benchmark's cell:
    random bytes drawn on the card, int32 and as a uint32 view."""
    gen = torch.Generator(cuda_device).manual_seed(20)
    n = 8192 * 128 * 256
    img = torch.randint(0, 256, (4 * n,), dtype=torch.uint8, device=cuda_device,
                        generator=gen).view(torch.int32).view(8192, 128, 256)
    _card_matches(img, cuda_device)
    _card_matches(img.view(torch.uint32), cuda_device)
