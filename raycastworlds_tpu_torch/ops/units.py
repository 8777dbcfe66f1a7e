"""Unit conversions and navigation primitives (0-indexed: tile ``i`` spans
world units ``[i, i+1)``, pixel ``p`` spans ``[p/ppu, (p+1)/ppu)``)."""

from __future__ import annotations

import torch


def wu_to_tu(x_wu: torch.Tensor) -> torch.Tensor:
    """World units -> tile index."""
    return torch.floor(x_wu).to(torch.int32)


def wu_to_pu(x_wu: torch.Tensor, pu_per_wu) -> torch.Tensor:
    """World units -> pixel index."""
    return torch.floor(x_wu * pu_per_wu).to(torch.int32)


def pu_to_tu(i_pu: torch.Tensor, pu_per_tu: int) -> torch.Tensor:
    """Pixel index -> tile index."""
    return i_pu // pu_per_tu


def turn_left(direction_au: torch.Tensor, num_directions: int) -> torch.Tensor:
    """+1 angle unit, modular."""
    return torch.remainder(direction_au + 1, num_directions)


def turn_right(direction_au: torch.Tensor, num_directions: int) -> torch.Tensor:
    """-1 angle unit, modular."""
    return torch.remainder(direction_au - 1, num_directions)


def move_forward(position_wu, direction_wu, position_increment_wu):
    return position_wu + position_increment_wu * direction_wu


def move_backward(position_wu, direction_wu, position_increment_wu):
    return position_wu - position_increment_wu * direction_wu
