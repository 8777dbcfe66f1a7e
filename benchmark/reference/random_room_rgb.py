"""The reference of the configuration ``random_room_rgb``: ``random_room``'s
world under the reset budget that ``configs/random_room_rgb.json`` states
(its top-level ``reset_budget``; the check hands a reference only the
configuration's ``env``), read from that file so the number lives in one
place."""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

from . import random_room
from .random_room import Spec

__all__ = ["Spec", "World", "reset_budget"]

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "random_room_rgb.json")


def reset_budget() -> int:
    with open(CONFIG) as f:
        return int(json.load(f)["reset_budget"])


class World(random_room.World):
    def __init__(self, env: Dict, num_envs: int, device, dtype=torch.float32):
        super().__init__(env, num_envs, device, reset_budget(), dtype)
