"""Plain reference of the RandomRoom world under a reset budget, batched
over envs in plain torch, with RGB frames.

The moves, the cast and the camera columns are SingleRoom's
(``single_room.World``), over a wall map of each env's own.  A reset draws
the env's world from its key, ``split(key, 5)`` -> next, map, goal, spawn,
heading, in that order:

* the map: the border walled, and each tile walled where a float32 uniform
  of the map key (element i of a row-major H x W draw) is below
  ``wall_density`` rounded to float32;
* the goal: uniform over the map's empty tiles by one float32 uniform u,
  the k-th empty tile of a row-major count with k = clip(floor(u * n), 0,
  max(n - 1, 0)) (tile 0 where none is empty); its wall, if any, cleared;
* the spawn: uniform by the same rule over the tiles other than the goal
  that a breadth-first search from the goal reaches through empty tiles in
  at most ``flood_iters`` 4-neighbour moves (H*W//2 + 2 where that is not
  positive), or over every empty tile where ``ensure_reachable`` is false;
  where no such tile is left (a walled-in goal), the tile above the goal,
  or below it where the goal is in row 1; its wall, if any, cleared;
* the heading: uniform over the ``num_directions`` angle units.

The reset budget: each step, the envs that ended and those still waiting
reset in index order from their own keys, at most ``reset_budget`` of them
(every one where it is 0).  The rest wait (``pending_reset``): a waiting
env discards its steps (its state kept, reward 0, not ended, never
truncated); its episode end was reported in the step it ended, and the
state it waits in holds that step's reward and end flag.

Frames are the RGB bytes of the 0x00RRGGBB camera view, uint8 [n, hpu, R,
3]; column sums are per channel, int64 [n, R, 3].  As in ``single_room``,
nothing here comes from the code under test.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional

import numpy as np
import torch

from . import threefry
from .single_room import CEILING, FLOOR, GOAL_I, GOAL_J, WALL_I, WALL_J, Spec
from .single_room import World as SingleRoomWorld

__all__ = ["Spec", "World", "reachable", "reset_draws"]

SHIFTS = (16, 8, 0)  # the R, G and B bytes of a 0x00RRGGBB colour


def uniforms(keys: np.ndarray, n: int) -> np.ndarray:
    """``n`` float32 uniforms in [0, 1) per key: float32 [..., n]."""
    bits = threefry.random_bits(keys, n)
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)


def kth_empty(keys: np.ndarray, occupied: np.ndarray) -> np.ndarray:
    """One tile per key (int64 [n, 2]), uniform over the tiles of
    ``occupied`` (bool [n, H, W]) that are False: the k-th of them in
    row-major order, tile 0 where there is none."""
    n, _, w = occupied.shape
    count = np.cumsum(~occupied.reshape(n, -1), axis=1)
    n_empty = count[:, -1].astype(np.float32)
    k = np.floor(threefry.uniform(keys) * n_empty)
    k = np.minimum(np.maximum(k, np.float32(0)), np.maximum(n_empty - 1, np.float32(0)))
    idx = np.argmax(count > k[:, None], axis=1)
    return np.stack([idx // w, idx % w], axis=-1)


def reachable(passable: np.ndarray, start, depth: int) -> np.ndarray:
    """bool [H, W]: the tiles of ``passable`` (bool [H, W]) that a
    breadth-first search from ``start`` (i, j) reaches through passable
    tiles in at most ``depth`` 4-neighbour moves (none where ``start`` is
    not passable)."""
    h, w = passable.shape
    open_ = passable.ravel().tolist()
    first = int(start[0]) * w + int(start[1])
    seen = [False] * (h * w)
    if not open_[first]:
        return np.zeros((h, w), dtype=bool)
    seen[first] = True
    queue = collections.deque([(first, 0)])
    while queue:
        tile, moves = queue.popleft()
        if moves == depth:
            continue
        i, j = divmod(tile, w)
        for ni, nj in ((i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1)):
            nxt = ni * w + nj
            if 0 <= ni < h and 0 <= nj < w and open_[nxt] and not seen[nxt]:
                seen[nxt] = True
                queue.append((nxt, moves + 1))
    return np.array(seen, dtype=bool).reshape(h, w)


def reset_draws(env: Dict, keys: np.ndarray):
    """The reset of each env from its key (uint32 [n, 2]): (next key
    [n, 2], walls bool [n, H, W], goal tile int64 [n, 2], spawn tile int64
    [n, 2], heading int64 [n])."""
    spec = Spec(env)
    h, w, n = spec.H, spec.W, keys.shape[0]
    sub = threefry.split(keys, 5)
    nxt, k_map, k_goal, k_spawn, k_dir = (sub[:, q] for q in range(5))
    walls = (uniforms(k_map, h * w) < np.float32(env["wall_density"])).reshape(n, h, w)
    walls[:, 0, :] = walls[:, -1, :] = True
    walls[:, :, 0] = walls[:, :, -1] = True
    goal = kth_empty(k_goal, walls)
    envs = np.arange(n)
    walls[envs, goal[:, 0], goal[:, 1]] = False
    if env["ensure_reachable"]:
        depth = env["flood_iters"] if env["flood_iters"] > 0 else h * w // 2 + 2
        valid = np.stack([reachable(~walls[e], goal[e], depth) for e in range(n)])
    else:
        valid = ~walls
    valid[envs, goal[:, 0], goal[:, 1]] = False
    gi = goal[:, 0]
    beside = np.stack([np.where(gi > 1, gi - 1, gi + 1), goal[:, 1]], axis=-1)
    has_valid = valid.reshape(n, -1).any(axis=1)
    spawn = np.where(has_valid[:, None], kth_empty(k_spawn, ~valid), beside)
    walls[envs, spawn[:, 0], spawn[:, 1]] = False
    heading = threefry.randint(k_dir, 1, 0, spec.D)[:, 0]
    return nxt, walls, goal, spawn, heading


class World(SingleRoomWorld):
    """``num_envs`` RandomRoom envs stepped in lockstep with auto-reset
    under ``reset_budget`` (0: every env that ends), on ``device``,
    geometry in ``dtype``.  ``walls`` is bool [B, H, W]; ``pending`` the
    envs waiting for a reset."""

    def __init__(self, env: Dict, num_envs: int, device, reset_budget: int = 0,
                 dtype=torch.float32):
        super().__init__(env, num_envs, device, dtype)
        self.env = env
        self.budget = min(reset_budget, num_envs) if reset_budget > 0 else num_envs

    # -- reset and step ---------------------------------------------------

    def reset(self, keys: np.ndarray) -> None:
        s = self.spec
        self.walls = torch.zeros((self.B, s.H, s.W), dtype=torch.bool, device=self.device)
        self.pending = torch.zeros(self.B, dtype=torch.bool, device=self.device)
        super().reset(keys)

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

    def _touches_wall(self, pos: torch.Tensor) -> torch.Tensor:
        s = self.spec
        base = torch.floor(pos).to(torch.int64)
        envs = torch.arange(pos.shape[0], device=pos.device)
        hit = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                tile = base + torch.tensor([di, dj], device=pos.device)
                wall = self.walls[envs, tile[:, 0].clamp(0, s.H - 1),
                                  tile[:, 1].clamp(0, s.W - 1)]
                hit = hit | (wall & self._touches(pos, tile))
        return hit

    def step(self, action: torch.Tensor):
        """One action per env; returns (reward, ended, truncated) of the
        moves, after which the envs the budget reached hold their next
        episode's start and the others wait."""
        s = self.spec
        live = ~self.pending
        a = action.to(self.device, torch.int64)
        moving = (a < 2) & live
        delta = self.inc * self.dir_table[self.dir]
        cand = torch.where((a == 0)[:, None], self.pos + delta, self.pos - delta)
        hit_goal = moving & self._touches(cand, self.goal)
        hit_wall = moving & self._touches_wall(cand)
        reward = torch.where(hit_goal, self.goal_reward, torch.zeros_like(self.goal_reward))
        commit = moving & ~hit_goal & ~hit_wall
        self.pos = torch.where(commit[:, None], cand, self.pos)
        turn = torch.where(a == 2, 1, torch.where(a == 3, -1, 0))
        self.dir = torch.where(live, torch.remainder(self.dir + turn, s.D), self.dir)
        self.t = torch.where(live, self.t + 1, self.t)
        self.ret = torch.where(live, self.ret + reward, self.ret)
        self.stepped_t, self.stepped_ret = self.t, self.ret
        if s.max_steps > 0:
            truncated = live & ~hit_goal & (self.t >= s.max_steps)
        else:
            truncated = torch.zeros_like(hit_goal)
        ended = hit_goal | truncated
        self.reward, self.done = reward, ended
        waiting = torch.nonzero(ended | self.pending).flatten().cpu().numpy()
        rows, rest = waiting[:self.budget], waiting[self.budget:]
        self.pending = torch.zeros_like(self.pending)
        self.pending[torch.from_numpy(rest).to(self.device)] = True
        if rows.size:
            self._reset_rows(rows, self.keys[rows])
        return reward, ended, truncated

    # -- cast and camera view ------------------------------------------------

    def _pick(self, x: torch.Tensor, rows: Optional[torch.Tensor]) -> torch.Tensor:
        return x if rows is None else x[rows]

    def cast(self, rows: Optional[torch.Tensor] = None):
        """(hit tile int64 [n, R, 2], hit face [n, R] 0 = i / 1 = j,
        distance f[n, R], rays) of the envs ``rows`` (all where None), each
        through its own walls and goal."""
        s = self.spec
        pos, hd, goal, walls = (self._pick(x, rows)
                                for x in (self.pos, self.dir, self.goal, self.walls))
        n = pos.shape[0]
        rays = self.fan_table[hd]
        occ = walls.reshape(n, -1).clone()
        occ[torch.arange(n, device=self.device), goal[:, 0] * s.W + goal[:, 1]] = True
        ti, ii, ji = self._axis(occ, rays[..., 0], rays[..., 1], pos[:, 0:1], pos[:, 1:2], True)
        tj, jj, ij = self._axis(occ, rays[..., 1], rays[..., 0], pos[:, 1:2], pos[:, 0:1], False)
        use_j = tj <= ti
        hit = torch.stack([torch.where(use_j, ij, ii), torch.where(use_j, jj, ji)], dim=-1)
        return hit, use_j.to(torch.int64), torch.where(use_j, tj, ti), rays

    def _columns(self, rows=None):
        """Per column, mirrored: (pad int64 [n, R], slab colour int64
        [n, R]), as ``single_room``'s, the slab a wall's where the env's
        own wall map has the hit tile."""
        s = self.spec
        hit, face, dist, rays = self.cast(rows)
        pd = self.dir_table[self._pick(self.dir, rows)]
        dot = pd[:, 0:1] * rays[..., 0] + pd[:, 1:2] * rays[..., 1]
        height = self.num / (self.denom * (dist * dot))
        h_pu = torch.where(torch.isfinite(height),
                           torch.floor(torch.clamp(height, max=float(s.hpu))),
                           torch.full_like(height, float(s.hpu))).to(torch.int64)
        pad = torch.where(h_pu >= s.hpu - 1, 0, (s.hpu - h_pu) // 2)
        walls = self._pick(self.walls, rows)
        envs = torch.arange(walls.shape[0], device=self.device)[:, None]
        wall = walls[envs, hit[..., 0].clamp(0, s.H - 1), hit[..., 1].clamp(0, s.W - 1)]
        colour = torch.where(wall, torch.where(face == 0, WALL_I, WALL_J),
                             torch.where(face == 0, GOAL_I, GOAL_J))
        return torch.flip(pad, dims=(1,)), torch.flip(colour, dims=(1,))

    def column_sums(self, rows=None) -> torch.Tensor:
        """int64 [n, R, 3]: each camera column's sum down its rows, per
        channel (R, G, B)."""
        pad, colour = self._columns(rows)
        band = self.spec.hpu - 2 * pad
        return torch.stack([pad * (((CEILING >> k) & 0xFF) + ((FLOOR >> k) & 0xFF))
                            + band * ((colour >> k) & 0xFF) for k in SHIFTS], dim=-1)

    def frames(self, rows=None) -> torch.Tensor:
        """uint8 [n, hpu, R, 3] camera views, the R, G and B bytes of each
        0x00RRGGBB pixel."""
        img = super().frames(rows)
        return torch.stack([(img >> k) & 0xFF for k in SHIFTS], dim=-1).to(torch.uint8)

    def leaves(self) -> Dict[str, np.ndarray]:
        """The state as host arrays under the port's leaf names, with each
        env's wall map and whether it waits for a reset."""
        out = super().leaves()
        out["wall_map"] = self.walls.cpu().numpy()
        out["pending_reset"] = self.pending.cpu().numpy()
        return out
