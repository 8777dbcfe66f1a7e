"""Plain reference of the Maze world under a reset budget, batched over
envs in plain torch, with 0x00RRGGBB camera frames.

The moves, the budget, the cast and the camera columns are RandomRoom's
(``random_room.World``: SingleRoom's geometry over a wall map of each env's
own); the frames and column sums are SingleRoom's u32 ones.  A reset draws
the env's maze from its key, ``split(key, 5)`` -> next, map, goal, spawn,
heading, in that order:

* the map, from the map key split in two (coin, rooms).  The H x W map
  (both odd) holds a CH x CW grid of cells at the odd tiles (CH = (H-1)/2,
  CW = (W-1)/2), everything else walled.  Cell (a, b) opens the wall to
  its north, tile (2a, 2b+1), when it is not in the top row and either
  sits in the left column or its coin (element a*CW + b of a row-major
  float32 uniform draw of the coin key) is below 0.5; otherwise it opens
  the wall to its west, tile (2a+1, 2b), unless it sits in the left
  column (cell (0, 0) opens nothing).  Then ``num_rooms`` rectangles are
  cleared, room r from key r of ``split(rooms, num_rooms)``, itself split
  in two (centre, size): a centre (i, j) uniform in [1, H-1) x [1, W-1)
  and half-extents (hi, hj) uniform in [1, room_max_half_tu], each pair
  drawn by ``jax.random.randint``'s rule (``threefry.randint``); the
  interior tiles with |row - i| <= hi and |col - j| <= hj lose their
  wall;
* the goal: one float32 uniform u over the map's n empty tiles, the k-th
  of a row-major count, k = clip(floor(u * n), 0, max(n - 1, 0));
* the spawn: the same rule over the map with the goal's tile walled too,
  so over n - 1 tiles;
* the heading: uniform over the ``num_directions`` angle units.

Departures from the JAX package's Maze, none of which changes a draw:
the spawn is drawn over the map with the goal filled in, where the JAX
package draws a rank over n - 1 tiles and bumps it past the goal's rank
on one shared count (the same tile by the order-statistics identity); the
prefix count is an integer cumsum where the JAX package sums float32
blocks (the counts are integers below 2**24 either way); every float
operation rounds alone (XLA on the CPU may fuse a multiply and an add);
the heading is discrete only, and geometry runs in ``dtype`` (float32 for
the configuration, lower for the control).  Nothing here comes from the
code under test.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import threefry
from .random_room import Spec, kth_empty, uniforms
from .random_room import World as RandomRoomWorld
from .single_room import World as SingleRoomWorld

__all__ = ["Spec", "World", "carve", "reset_draws"]


def carve(env: Dict, k_map: np.ndarray) -> np.ndarray:
    """bool [n, H, W]: the maze of each map key (uint32 [n, 2])."""
    h, w = int(env["height_tile_map_tu"]), int(env["width_tile_map_tu"])
    ch, cw, n = (h - 1) // 2, (w - 1) // 2, k_map.shape[0]
    k_coin, k_rooms = (threefry.split(k_map, 2)[:, q] for q in range(2))
    heads = (uniforms(k_coin, ch * cw) < np.float32(0.5)).reshape(n, ch, cw)
    a = np.arange(ch)[:, None]
    b = np.arange(cw)[None, :]
    north = (a > 0) & ((b == 0) | heads)              # [n, CH, CW]
    west = ~north & (b > 0)
    walls = np.ones((n, h, w), dtype=bool)
    envs, ca, cb = np.meshgrid(np.arange(n), np.arange(ch), np.arange(cw), indexing="ij")
    ti, tj = 2 * ca + 1, 2 * cb + 1                   # each cell's tile
    walls[envs, ti, tj] = False
    walls[envs[north], ti[north] - 1, tj[north]] = False
    walls[envs[west], ti[west], tj[west] - 1] = False
    rooms = int(env["num_rooms"])
    if rooms > 0:
        per_room = threefry.split(k_rooms, rooms)     # [n, rooms, 2]
        rows = np.arange(h)[None, :, None]
        cols = np.arange(w)[None, None, :]
        inner = (rows > 0) & (rows < h - 1) & (cols > 0) & (cols < w - 1)
        for r in range(rooms):
            k_centre, k_size = (threefry.split(per_room[:, r], 2)[:, q] for q in range(2))
            ci, cj = threefry.randint(k_centre, 2, [1, 1], [h - 1, w - 1]).T
            hi, hj = threefry.randint(k_size, 2, 1, int(env["room_max_half_tu"]) + 1).T
            room = ((np.abs(rows - ci[:, None, None]) <= hi[:, None, None])
                    & (np.abs(cols - cj[:, None, None]) <= hj[:, None, None]) & inner)
            walls &= ~room
    return walls


def reset_draws(env: Dict, keys: np.ndarray):
    """The reset of each env from its key (uint32 [n, 2]): (next key
    [n, 2], walls bool [n, H, W], goal tile int64 [n, 2], spawn tile int64
    [n, 2], heading int64 [n])."""
    n = keys.shape[0]
    sub = threefry.split(keys, 5)
    nxt, k_map, k_goal, k_spawn, k_dir = (sub[:, q] for q in range(5))
    walls = carve(env, k_map)
    goal = kth_empty(k_goal, walls)
    filled = walls.copy()
    filled[np.arange(n), goal[:, 0], goal[:, 1]] = True
    spawn = kth_empty(k_spawn, filled)
    heading = threefry.randint(k_dir, 1, 0, int(env["num_directions"]))[:, 0]
    return nxt, walls, goal, spawn, heading


class World(RandomRoomWorld):
    """``num_envs`` Maze envs stepped in lockstep with auto-reset under
    ``reset_budget`` (0: every env that ends), on ``device``, geometry in
    ``dtype``; frames and column sums as SingleRoom's."""

    column_sums = SingleRoomWorld.column_sums
    frames = SingleRoomWorld.frames

    def _reset_rows(self, rows: np.ndarray, keys: np.ndarray) -> None:
        nxt, walls, goal, spawn, heading = reset_draws(self.env, keys)
        dev = self.device
        self.keys[rows] = nxt
        idx = torch.from_numpy(rows).to(dev)
        # out of place: a state handed out earlier keeps its values
        self.walls = self.walls.index_copy(0, idx, torch.from_numpy(walls).to(dev))
        self.goal = self.goal.index_copy(0, idx, torch.from_numpy(goal).to(dev))
        self.pos = self.pos.index_copy(
            0, idx, torch.from_numpy(spawn).to(dev, self.dtype) + self.half)
        self.dir = self.dir.index_copy(0, idx, torch.from_numpy(heading).to(dev))
        self.t = self.t.index_fill(0, idx, 0)
        self.ret = self.ret.index_fill(0, idx, 0)
