"""The reference of the configuration ``multi_player_2p``: ``multi_player``'s
world, whose players, collision and sprite rules the configuration's
``env`` states (``configs/multi_player_2p.json``: two players, collision
on, the others drawn as sprites 0.5 wu tall)."""

from __future__ import annotations

from .multi_player import Spec, World

__all__ = ["Spec", "World"]
