"""The DDA cast as a hand-written CUDA kernel (``csrc/dda_cast.cu``).

The port of the JAX package's Pallas kernel of the same module name
(backend ``pallas``).  Its contract is the scan's, bit for bit: for a CUDA
tensor the wrapper launches the kernel; for a CPU tensor it runs the plain
scan (:func:`raycast.cast_rays_scan`), which the tests hold against the JAX
package and ``chip_smoke.py`` holds the kernel against on the card.  There
is no fallback: any other device, a dtype or shape the kernel does not
take, or a failed launch raises.

The JAX kernel advances the untaken axis as ``side + go * delta``, which is
NaN on a ray with an exact-zero component (``0 * inf``); the scan, and so
this port, selects instead.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import cuda_build
from ..config import EnvConfig
from . import lut, raycast


def cast_rays_pallas_batched(
    obstacle_words: torch.Tensor,   # i32[B, NW] packed obstacle words
    shape: Tuple[int, int],
    pos_wu: torch.Tensor,           # f32[B, 2]
    ray_dirs: torch.Tensor,         # f32[B, R, 2]
    max_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch DDA over ``max_steps`` steps.  Returns (hit_tu i32[B, R, 2],
    hit_dim i32[B, R], dist f32[B, R]).  Any B >= 1 and any R; raises where
    the map's words exceed what the kernel's shared memory holds.
    """
    raycast.check_cast_inputs(obstacle_words, shape, pos_wu, ray_dirs)
    if max_steps < 0:
        raise ValueError(f"max_steps must be >= 0, got {max_steps}")
    dev = pos_wu.device
    if dev.type == "cpu":
        return raycast.cast_rays_scan(obstacle_words, shape, pos_wu, ray_dirs, max_steps)
    b, r = ray_dirs.shape[0], ray_dirs.shape[1]
    nw = obstacle_words.shape[1]
    lib = cuda_build.kernel_library(
        dev, nw, b, r, "DDA cast", obstacle_words=obstacle_words,
        pos_wu=pos_wu, ray_dirs=ray_dirs,
    )
    h, w = shape
    hit_tu = torch.empty((b, r, 2), dtype=torch.int32, device=dev)
    hit_dim = torch.empty((b, r), dtype=torch.int32, device=dev)
    dist = torch.empty((b, r), dtype=torch.float32, device=dev)
    cuda_build.launch(
        lib.rcw_dda_cast, dev,
        obstacle_words.data_ptr(), pos_wu.data_ptr(), ray_dirs.data_ptr(),
        hit_tu.data_ptr(), hit_dim.data_ptr(), dist.data_ptr(),
        b, r, h, w, nw, max_steps, what="DDA cast",
    )
    return hit_tu, hit_dim, dist


def cast_rays_pallas(
    cfg: EnvConfig,
    obstacle_words: torch.Tensor,   # i32[NW]
    pos_wu: torch.Tensor,           # f32[2]
    dir_au: torch.Tensor,           # i32[]
) -> raycast.RayHits:
    """One env's cast through :func:`cast_rays_pallas_batched` at B=1 (the
    DDA kernel on a CUDA tensor, the plain scan on a CPU tensor), over the
    heading's fan from ``cfg.ray_fan_lut``; ``RayHits`` of [R, ...]."""
    dirs = lut.take_rows(torch.as_tensor(cfg.ray_fan_lut, device=pos_wu.device), dir_au)
    hit_tu, hit_dim, dist = cast_rays_pallas_batched(
        obstacle_words[None], (cfg.H, cfg.W), pos_wu[None], dirs[None], cfg.dda_steps)
    return raycast.RayHits(ray_dirs=dirs, hit_tu=hit_tu[0], hit_dim=hit_dim[0], dist_wu=dist[0])
