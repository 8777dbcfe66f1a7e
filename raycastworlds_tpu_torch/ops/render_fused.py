"""The DDA cast fused with the u32 camera render, as a hand-written CUDA
kernel (``csrc/dda_render_u32.cu``).

The port of the JAX package's Pallas kernel of the same module name
(backend ``fused``).  Its contract is the scan followed by the u32 render,
bit for bit: for a CUDA tensor the wrapper launches the kernel; for a CPU
tensor it runs :func:`render_camera_fused_batched_ref` (the plain scan and
:func:`render.camera_u32`), which the tests hold against the JAX package and
``chip_smoke.py`` holds the kernel against on the card.  There is no
fallback: any other device, a dtype or shape the kernel does not take, or a
failed launch raises.

The fan arrives mirror-ordered (``EnvConfig.ray_fan_lut_flipped``), so the
kernel writes image column ``r`` from ray ``r``.  Images are int32 bit
patterns of 0x00RRGGBB, as the plain render builds them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import cuda_build
from ..config import EnvConfig
from . import lut, raycast, render


def render_camera_fused_batched_ref(
    obstacle_words, wall_words, shape, pos_wu, player_dir_wu,
    ray_dirs_flipped, max_steps, hpu, num_f, denom_f, block_words=None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the scan on the fan in ray order,
    then the u32 render, which mirrors the columns back."""
    dirs = torch.flip(ray_dirs_flipped, dims=(1,))
    hit_tu, hit_dim, dist = raycast.cast_rays_scan(
        obstacle_words, shape, pos_wu, dirs, max_steps
    )
    hits = raycast.RayHits(ray_dirs=dirs, hit_tu=hit_tu, hit_dim=hit_dim, dist_wu=dist)
    return render.camera_u32(wall_words, shape, player_dir_wu, hits, hpu,
                             num_f, denom_f, block_words)


def render_camera_fused_batched(
    obstacle_words: torch.Tensor,     # i32[B, NW]
    wall_words: torch.Tensor,         # i32[B, NW]
    shape: Tuple[int, int],
    pos_wu: torch.Tensor,             # f32[B, 2]
    player_dir_wu: torch.Tensor,      # f32[B, 2]
    ray_dirs_flipped: torch.Tensor,   # f32[B, R, 2], mirror-ordered fan
    max_steps: int,
    hpu: int,
    num_f: float,
    denom_f: float,
    block_words: Optional[torch.Tensor] = None,  # i32[B, NW]
) -> torch.Tensor:
    """int32[B, hpu, R] 0x00RRGGBB camera views, march and render in one
    kernel.  ``num_f`` and ``denom_f`` are the float32 render constants
    (:func:`render.render_constants`).
    """
    raycast.check_cast_inputs(obstacle_words, shape, pos_wu, ray_dirs_flipped)
    nw = obstacle_words.shape[1]
    raycast.check_env_tensor("wall_words", wall_words, pos_wu, torch.int32, (nw,))
    if block_words is not None:
        raycast.check_env_tensor("block_words", block_words, pos_wu, torch.int32, (nw,))
    raycast.check_env_tensor("player_dir_wu", player_dir_wu, pos_wu, torch.float32, (2,))
    if hpu < 1 or max_steps < 0:
        raise ValueError(f"need hpu >= 1 and max_steps >= 0, got {hpu}, {max_steps}")
    dev = pos_wu.device
    if dev.type == "cpu":
        return render_camera_fused_batched_ref(
            obstacle_words, wall_words, shape, pos_wu, player_dir_wu,
            ray_dirs_flipped, max_steps, hpu, num_f, denom_f, block_words,
        )
    b, r = ray_dirs_flipped.shape[0], ray_dirs_flipped.shape[1]
    words = dict(obstacle_words=obstacle_words, wall_words=wall_words)
    if block_words is not None:
        words["block_words"] = block_words
    lib = cuda_build.kernel_library(
        dev, nw * len(words), b, r, "DDA + u32 render", pos_wu=pos_wu,
        player_dir_wu=player_dir_wu, ray_dirs_flipped=ray_dirs_flipped,
        **words,
    )
    h, w = shape
    img = torch.empty((b, hpu, r), dtype=torch.int32, device=dev)
    cuda_build.launch(
        lib.rcw_dda_render_u32, dev,
        obstacle_words.data_ptr(), wall_words.data_ptr(),
        None if block_words is None else block_words.data_ptr(),
        pos_wu.data_ptr(), player_dir_wu.data_ptr(),
        ray_dirs_flipped.data_ptr(), img.data_ptr(),
        b, r, h, w, nw, max_steps, hpu, num_f, denom_f,
        what="DDA + u32 render",
    )
    return img


def render_camera_fused(
    cfg: EnvConfig,
    obstacle_words: torch.Tensor,   # i32[B, NW]
    wall_words: torch.Tensor,       # i32[B, NW]
    pos_wu: torch.Tensor,           # f32[B, 2]
    dir_au: torch.Tensor,           # i32[B]
    block_words: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Config-level entry: the mirror-ordered fan and player direction of
    each heading, then the fused kernel.  Returns int32[B, H_pu, R], equal
    to the scan + u32 render path."""
    dev = pos_wu.device
    table = lambda name: torch.from_numpy(getattr(cfg, name)).to(dev)  # noqa: E731
    return render_camera_fused_batched(
        obstacle_words, wall_words, (cfg.H, cfg.W), pos_wu,
        lut.take_rows(table("directions_wu"), dir_au),
        lut.take_rows(table("ray_fan_lut_flipped"), dir_au),
        cfg.dda_steps, cfg.height_camera_view_pu, *render.render_constants(cfg),
        block_words=block_words,
    )
