"""Reachability by iterated 4-neighbour dilation, batched over envs.

A fixed trip count (``H*W//2 + 2`` unless given) bounds every shortest path
on an H x W grid.  On the card the fill is one launch of the CUDA kernel
``csrc/flood_fill.cu`` (counted as ``kernel_launches.flood_fill``), which
runs the dilations on the chip and stops at the first that changes nothing:
that is a fixed point, so the remaining dilations would leave it as it is.
Any other tensor takes the plain version, :func:`flood_fill_plain`, whose
loop never exits early: testing for a fixed point would read the device from
the host once per iteration.  The tests hold the kernel to it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import cuda_build
from ..utils import profiling

# Words of one env's map (``H * ceil(W / 32)``) the kernel's block holds
# (``kMaxWords`` in ``csrc/flood_fill.cu``): every map up to 256 x 256
# tiles and more.
KERNEL_MAX_WORDS = 4096


def dilate4(mask: torch.Tensor) -> torch.Tensor:
    """4-neighbour binary dilation of bool[B, H, W] (outside is False)."""
    out = mask.clone()
    out[:, :-1, :] |= mask[:, 1:, :]
    out[:, 1:, :] |= mask[:, :-1, :]
    out[:, :, :-1] |= mask[:, :, 1:]
    out[:, :, 1:] |= mask[:, :, :-1]
    return out


def flood_fill_plain(
    passable: torch.Tensor, seed_tu: torch.Tensor, num_iters: int
) -> torch.Tensor:
    """:func:`flood_fill` in torch ops on any device: ``num_iters``
    dilations, none skipped."""
    _, h, w = passable.shape
    ii = torch.arange(h, device=passable.device)[None, :, None]
    jj = torch.arange(w, device=passable.device)[None, None, :]
    seed = (ii == seed_tu[:, 0, None, None]) & (jj == seed_tu[:, 1, None, None])
    reach = seed & passable
    for _ in range(num_iters):
        reach = dilate4(reach) & passable
    return reach


def _uses_kernel(passable: torch.Tensor) -> bool:
    """The fill's dispatch: a CUDA map goes to the kernel (or raises), any
    other takes the plain version."""
    return passable.device.type == "cuda"


def _flood_fill_kernel(
    passable: torch.Tensor, seed_tu: torch.Tensor, num_iters: int
) -> torch.Tensor:
    """The CUDA kernel's fill: one launch, an output allocated empty, no
    host read.  Raises on inputs the kernel does not take: a map other than
    a contiguous bool[B, H, W], seeds other than contiguous int32[B, 2] on
    its device, or a map of more than KERNEL_MAX_WORDS words."""
    if passable.dtype != torch.bool or passable.dim() != 3 or not passable.is_contiguous():
        raise ValueError(f"passable must be a contiguous bool [B, H, W], not "
                         f"{passable.dtype} {list(passable.shape)}")
    b, h, w = passable.shape
    if (seed_tu.dtype != torch.int32 or tuple(seed_tu.shape) != (b, 2)
            or not seed_tu.is_contiguous() or seed_tu.device != passable.device):
        raise ValueError(f"seed_tu must be a contiguous int32 [{b}, 2] on {passable.device}, "
                         f"not {seed_tu.dtype} {list(seed_tu.shape)} on {seed_tu.device}")
    words = h * -(-w // 32)
    if words > KERNEL_MAX_WORDS:
        raise ValueError(f"a {h} x {w} map is {words} words (H * ceil(W / 32)), more than "
                         f"the flood fill kernel's block holds (KERNEL_MAX_WORDS = "
                         f"{KERNEL_MAX_WORDS})")
    out = torch.empty_like(passable)
    if out.numel() == 0:
        return out
    # every fill reaches its fixed point within H * W rounds
    rounds = max(0, min(num_iters, h * w))
    lib = cuda_build.load()
    cuda_build.launch(lib.rcw_flood_fill, passable.device, passable.data_ptr(),
                      seed_tu.data_ptr(), out.data_ptr(), b, h, w, rounds, what="flood fill")
    return out


@profiling.span("rcw.ops.flood_fill")
def flood_fill(
    passable: torch.Tensor, seed_tu: torch.Tensor, num_iters: Optional[int] = None
) -> torch.Tensor:
    """Tiles of ``passable`` (bool[B, H, W]) reachable from ``seed_tu``
    (i32[B, 2]) under 4-connectivity, after ``num_iters`` dilations
    (counted as ``flood_dilations``).  A CUDA map launches the kernel; any
    other takes :func:`flood_fill_plain`."""
    _, h, w = passable.shape
    if num_iters is None:
        num_iters = h * w // 2 + 2
    profiling.count("flood_dilations", num_iters)
    if _uses_kernel(passable):
        return _flood_fill_kernel(passable, seed_tu, num_iters)
    return flood_fill_plain(passable, seed_tu, num_iters)
