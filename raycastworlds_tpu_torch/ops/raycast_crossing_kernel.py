"""The crossing cast as a hand-written CUDA kernel (``csrc/crossing_cast.cu``).

The port of the JAX package's Pallas kernel of the same module name.  For a
CUDA tensor the wrapper launches the kernel; for a CPU tensor it runs
:func:`cast_rays_crossing_kernel_ref`, the kernel's plain PyTorch version,
which the tests hold against the JAX package and ``chip_smoke.py`` holds
the kernel against on the card.  There is no fallback: any other device,
a dtype or shape the kernel does not take, or a failed launch raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import bitmap

_BIG = float(np.finfo(np.float32).max)
_MAX_RAY_CHUNKS = 65535  # grid.y limit; rays go in chunks of 128


def _axis_loop_ref(
    words, w, d_main, d_cross, p_main, p_cross, n, size_cross, main_is_i
):
    """One axis of the kernel, as the kernel computes it: a loop over the
    n candidates with a running (t, k, cross tile) min in ``[B, R]``
    tensors, strict ``<`` in ascending k, and a direct bit test of the
    entered tile."""
    fl = torch.floor(p_main)
    main0 = fl.to(torch.int32)                                   # [B, 1]
    neg = d_main < 0
    step = torch.where(neg, -1, 1).to(torch.int32)
    frac = p_main - fl
    frac_sel = torch.where(neg, frac, 1.0 - frac)
    ad = torch.abs(d_main)
    best = torch.full_like(d_main, _BIG)
    kb = torch.zeros_like(step)
    cb = torch.zeros_like(step)
    for k in range(n):
        t = (frac_sel + float(k)) / ad
        finite = torch.isfinite(t)
        c = torch.where(finite, p_cross + t * d_cross, 0.0)
        if main_is_i:
            c_tile = torch.where(d_cross >= 0, torch.floor(c), torch.ceil(c) - 1.0)
        else:
            c_tile = torch.where(d_cross > 0, torch.ceil(c) - 1.0, torch.floor(c))
        c_idx = torch.clamp(c_tile, 0.0, float(size_cross - 1)).to(torch.int32)
        m = torch.clamp(main0 + (k + 1) * step, 0, n - 1)
        bit = m * w + c_idx if main_is_i else c_idx * w + m
        occ = bitmap.lookup_bit(words, bit) & finite
        t_m = torch.where(occ, t, _BIG)
        better = t_m < best
        best = torch.where(better, t_m, best)
        kb = torch.where(better, k, kb)
        cb = torch.where(better, c_idx, cb)
    return best, main0 + (kb + 1) * step, cb


def cast_rays_crossing_kernel_ref(
    obstacle_words: torch.Tensor,
    shape: Tuple[int, int],
    pos_wu: torch.Tensor,
    ray_dirs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: same contract, same arithmetic."""
    h, w = shape
    dx = ray_dirs[..., 0]
    dy = ray_dirs[..., 1]
    px = pos_wu[:, 0:1]
    py = pos_wu[:, 1:2]
    ti, ii, ji = _axis_loop_ref(obstacle_words, w, dx, dy, px, py, h, w, True)
    tj, jj, ij = _axis_loop_ref(obstacle_words, w, dy, dx, py, px, w, h, False)
    use_j = tj <= ti  # ties check j first, like the sequential march
    dist = torch.where(use_j, tj, ti)
    hit_i = torch.where(use_j, ij, ii)
    hit_j = torch.where(use_j, jj, ji)
    return torch.stack([hit_i, hit_j], dim=-1), use_j.to(torch.int32), dist


def _check_inputs(obstacle_words, shape, pos_wu, ray_dirs):
    h, w = shape
    if obstacle_words.dim() != 2 or pos_wu.dim() != 2 or ray_dirs.dim() != 3:
        raise ValueError("expected words [B, NW], pos [B, 2], dirs [B, R, 2]")
    b, nw = obstacle_words.shape
    if nw != bitmap.n_words(h * w):
        raise ValueError(f"{nw} words do not pack a {h}x{w} map")
    if tuple(pos_wu.shape) != (b, 2) or ray_dirs.shape[0] != b or ray_dirs.shape[2] != 2:
        raise ValueError(
            f"shape mismatch: words {tuple(obstacle_words.shape)}, "
            f"pos {tuple(pos_wu.shape)}, dirs {tuple(ray_dirs.shape)}"
        )
    if obstacle_words.dtype != torch.int32:
        raise TypeError(f"obstacle_words must be int32, got {obstacle_words.dtype}")
    if pos_wu.dtype != torch.float32 or ray_dirs.dtype != torch.float32:
        raise TypeError("pos_wu and ray_dirs must be float32")
    devs = {obstacle_words.device, pos_wu.device, ray_dirs.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")


def cast_rays_crossing_kernel(
    obstacle_words: torch.Tensor,   # i32[B, NW] packed obstacle words
    shape: Tuple[int, int],
    pos_wu: torch.Tensor,           # f32[B, 2]
    ray_dirs: torch.Tensor,         # f32[B, R, 2]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch crossing cast.  Returns (hit_tu i32[B, R, 2], hit_dim i32[B, R],
    dist f32[B, R]).  Any B >= 1 and any R; raises where the map's words
    exceed what the kernel's shared memory holds.

    ``cast_rays_crossing_kernel.launches`` counts kernel launches.
    """
    _check_inputs(obstacle_words, shape, pos_wu, ray_dirs)
    dev = pos_wu.device
    if dev.type == "cpu":
        return cast_rays_crossing_kernel_ref(obstacle_words, shape, pos_wu, ray_dirs)
    if dev.type != "cuda":
        raise ValueError(f"no crossing kernel for device {dev}")
    for name, x in (("obstacle_words", obstacle_words), ("pos_wu", pos_wu),
                    ("ray_dirs", ray_dirs)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    from .. import cuda_build

    lib = cuda_build.load()
    h, w = shape
    b, r = ray_dirs.shape[0], ray_dirs.shape[1]
    nw = obstacle_words.shape[1]
    if nw > lib.rcw_crossing_cast_max_words():
        raise ValueError(
            f"a {h}x{w} map needs {nw} words, more than the kernel's shared "
            f"memory holds ({lib.rcw_crossing_cast_max_words()})"
        )
    if b < 1 or r < 1 or -(-r // 128) > _MAX_RAY_CHUNKS:
        raise ValueError(f"unsupported batch shape B={b}, R={r}")
    hit_tu = torch.empty((b, r, 2), dtype=torch.int32, device=dev)
    hit_dim = torch.empty((b, r), dtype=torch.int32, device=dev)
    dist = torch.empty((b, r), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rcw_crossing_cast(
            obstacle_words.data_ptr(), pos_wu.data_ptr(), ray_dirs.data_ptr(),
            hit_tu.data_ptr(), hit_dim.data_ptr(), dist.data_ptr(),
            b, r, h, w, nw, stream,
        )
    if err != 0:
        raise RuntimeError(f"crossing cast kernel launch failed: CUDA error {err}")
    cast_rays_crossing_kernel.launches += 1
    return hit_tu, hit_dim, dist


cast_rays_crossing_kernel.launches = 0
