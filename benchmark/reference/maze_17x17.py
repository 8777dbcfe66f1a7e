"""The reference of the configuration ``maze_17x17``: ``maze``'s world under
the reset budget that ``configs/maze_17x17.json`` states (its top-level
``reset_budget``; the check hands a reference only the configuration's
``env``), read from that file so the number lives in one place."""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

from . import maze
from .maze import Spec

__all__ = ["Spec", "World", "reset_budget"]

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "maze_17x17.json")


def reset_budget() -> int:
    with open(CONFIG) as f:
        return int(json.load(f)["reset_budget"])


class World(maze.World):
    def __init__(self, env: Dict, num_envs: int, device, dtype=torch.float32):
        super().__init__(env, num_envs, device, reset_budget(), dtype)
