"""On-device random draws of the SingleRoom reset, batched over keys.

Each function takes keys ``[B, 2]`` (see ``rng``) and draws for every key
exactly what the JAX package's unbatched function draws for that key alone.
The general masked samplers (``sample_empty_tile`` and friends) come with
the families that use them (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import torch

from .. import rng


def interior_rank(tile: torch.Tensor, w: int) -> torch.Tensor:
    """Row-major interior rank ``(i-1)*(W-2) + (j-1)`` of interior tiles
    i32[..., 2]."""
    return (tile[..., 0] - 1) * (w - 2) + (tile[..., 1] - 1)


def sample_interior_tile(key: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Uniform tile in the interior ``[1, H-1) x [1, W-1)``: i32[B, 2]."""
    return rng.randint(key, (2,), [1, 1], [h - 1, w - 1])


def sample_heading(key: torch.Tensor, num_directions: int) -> torch.Tensor:
    """Uniform discrete heading in ``[0, num_directions)``: i32[B]
    (continuous headings are ROADMAP Queue 1 item 16)."""
    return rng.randint(key, (), 0, num_directions)
