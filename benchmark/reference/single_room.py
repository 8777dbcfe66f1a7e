"""Plain reference of the SingleRoom world, batched over envs in plain torch.

The semantics are RayCastWorlds.jl's SingleRoom (``src/single_room.jl``)
0-indexed, as the project's scalar oracle states them: a walled H x W room
with one goal tile and a circular player; actions 0/1 move one increment
along the heading, 2/3 turn by one angle unit; a move whose circle touches
the goal pays ``goal_reward`` and ends the episode without moving, one that
touches a wall is blocked.  Rays lerp across the camera plane and are
normalised; each is cast by its grid-line crossings (the closed-form
``(frac + k) / |d|`` of crossing k, the nearest occupied tile wins, a tie
goes to the j face); the camera view is a mirrored ceiling / wall / floor
column per ray.  An episode that ends is reset within the same step from
the env's key (``split(key, 4)`` -> next, goal, spawn, heading; the spawn
is the k-th empty tile of a row-major count), and the reward and end flag
of the finishing move stay on the reset state.

Nothing here comes from the code under test: the tables are worked out
again from the configuration, the random draws by ``threefry``.  Geometry
runs in ``dtype`` (the configuration's float32, or a lower precision for
the control); every sum and product is its own rounded operation, and
every division divides by a tensor on the device, so the results are the
same on the CPU and on the GPU.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from . import threefry

# 0x00RRGGBB colours of the camera view (RayCastWorlds.jl's palette).
CEILING = 0xFFFFFF
FLOOR = 0x404040
WALL_I, WALL_J = 0x808080, 0xC0C0C0
GOAL_I, GOAL_J = 0x800000, 0xC00000


class Spec:
    """The sizes of one configuration's ``env`` block."""

    def __init__(self, env: Dict):
        self.H = int(env["height_tile_map_tu"])
        self.W = int(env["width_tile_map_tu"])
        self.D = int(env["num_directions"])
        self.R = int(env["num_rays"])
        self.hpu = int(env["height_camera_view_pu"])
        self.radius = float(env["player_radius_wu"])
        self.inc = float(env["position_increment_wu"])
        self.sfov = float(env["semi_field_of_view_wu"])
        self.cam_h = float(env["camera_height_tile_wu"])
        self.goal_reward = float(env["goal_reward"])
        self.max_steps = int(env.get("max_episode_steps", 0))
        self.num_actions = 4

    def directions(self) -> np.ndarray:
        """float64 [D, 2] heading vectors: angle unit a is a * 2 pi / D."""
        theta = np.arange(self.D, dtype=np.float64) * (2.0 * math.pi / self.D)
        return np.stack([np.cos(theta), np.sin(theta)], axis=-1)

    def ray_fans(self) -> np.ndarray:
        """float64 [D, R, 2] normalised rays of each heading, lerped from
        ``dir + sfov * cam`` to ``dir - sfov * cam``, ``cam`` the heading
        turned by -90 degrees."""
        dirs = self.directions()
        cam = np.stack([dirs[:, 1], -dirs[:, 0]], axis=-1)
        first = dirs + self.sfov * cam
        last = dirs - self.sfov * cam
        t = (np.arange(self.R, dtype=np.float64) / (self.R - 1))[None, :, None]
        fan = first[:, None, :] + t * (last - first)[:, None, :]
        fan /= np.linalg.norm(fan, axis=-1, keepdims=True)
        return fan


def reset_draws(spec: Spec, keys: np.ndarray):
    """The reset of each env from its key (uint32 [n, 2]): (next key
    [n, 2], goal tile int64 [n, 2], spawn tile int64 [n, 2], heading int64
    [n]).  The goal is uniform over the interior; the spawn uniform over
    the tiles that are neither wall nor goal, by one float32 uniform u:
    the k-th empty tile, k = clip(floor(u * n_empty), 0, n_empty - 1)."""
    h, w = spec.H, spec.W
    sub = threefry.split(keys, 4)
    nxt, k_goal, k_spawn, k_dir = (sub[:, q] for q in range(4))
    goal = threefry.randint(k_goal, 2, [1, 1], [h - 1, w - 1])
    occupied = np.zeros((keys.shape[0], h, w), dtype=bool)
    occupied[:, 0, :] = occupied[:, -1, :] = True
    occupied[:, :, 0] = occupied[:, :, -1] = True
    occupied[np.arange(keys.shape[0]), goal[:, 0], goal[:, 1]] = True
    count = np.cumsum(~occupied.reshape(keys.shape[0], -1), axis=1)
    n_empty = count[:, -1]
    u = threefry.uniform(k_spawn)
    k = np.floor(u * n_empty.astype(np.float32)).astype(np.int64)
    k = np.minimum(np.maximum(k, 0), np.maximum(n_empty - 1, 0))
    idx = np.argmax(count > k[:, None], axis=1)
    spawn = np.stack([idx // w, idx % w], axis=-1)
    heading = threefry.randint(k_dir, 1, 0, spec.D)[:, 0]
    return nxt, goal, spawn, heading


class World:
    """``num_envs`` SingleRoom envs stepped in lockstep with dense
    auto-reset, on ``device``, geometry in ``dtype``.  The keys live on the
    host (``keys``, uint32 [B, 2]); the rest of the state is tensors."""

    def __init__(self, env: Dict, num_envs: int, device, dtype=torch.float32):
        self.spec = s = Spec(env)
        self.B = num_envs
        self.device = torch.device(device)
        self.dtype = dtype
        f = lambda v: torch.tensor(v, dtype=dtype, device=self.device)  # noqa: E731
        self.dir_table = torch.from_numpy(s.directions()).to(self.device, dtype)
        self.fan_table = torch.from_numpy(s.ray_fans()).to(self.device, dtype)
        self.inc = f(s.inc)
        r = f(s.radius)
        self.r2 = r * r
        self.half = f(0.5)
        self.big = f(torch.finfo(dtype).max)
        self.num = f(s.cam_h * s.R)
        self.denom = f(2.0 * s.sfov)
        self.goal_reward = f(s.goal_reward)
        walls = torch.zeros((s.H, s.W), dtype=torch.bool, device=self.device)
        walls[0, :] = walls[-1, :] = True
        walls[:, 0] = walls[:, -1] = True
        self.walls = walls
        self.keys = np.zeros((num_envs, 2), dtype=np.uint32)

    @classmethod
    def at(cls, env: Dict, pos: torch.Tensor, heading: torch.Tensor,
           goal: torch.Tensor, dtype=torch.float32) -> "World":
        """A world whose envs stand at the given poses and goals (for
        casting from poses the reference did not make)."""
        w = cls(env, pos.shape[0], pos.device, dtype)
        w.pos = pos.to(dtype)
        w.dir = heading.to(torch.int64)
        w.goal = goal.to(torch.int64)
        return w

    # -- reset and step ---------------------------------------------------

    def reset(self, keys: np.ndarray) -> None:
        """Every env from its own key (uint32 [B, 2])."""
        b, dev = self.B, self.device
        self.goal = torch.zeros((b, 2), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((b, 2), dtype=self.dtype, device=dev)
        self.dir = torch.zeros(b, dtype=torch.int64, device=dev)
        self.t = torch.zeros(b, dtype=torch.int64, device=dev)
        self.ret = torch.zeros(b, dtype=self.dtype, device=dev)
        self.reward = torch.zeros(b, dtype=self.dtype, device=dev)
        self.done = torch.zeros(b, dtype=torch.bool, device=dev)
        self._reset_rows(np.arange(b), keys)

    def _reset_rows(self, rows: np.ndarray, keys: np.ndarray) -> None:
        nxt, goal, spawn, heading = reset_draws(self.spec, keys)
        self.keys[rows] = nxt
        idx = torch.from_numpy(rows).to(self.device)
        dev = self.device
        self.goal[idx] = torch.from_numpy(goal).to(dev)
        self.pos[idx] = torch.from_numpy(spawn).to(dev, self.dtype) + self.half
        self.dir[idx] = torch.from_numpy(heading).to(dev)
        self.t = self.t.index_fill(0, idx, 0)
        self.ret = self.ret.index_fill(0, idx, 0)

    def _touches(self, pos: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
        """The circle at ``pos`` (f[..., 2]) overlaps the unit square of
        ``tile`` (int[..., 2]): the squared distance from the centre to its
        clamp onto the square is under r**2."""
        rel = pos - (tile.to(self.dtype) + self.half)
        e = rel - torch.clamp(rel, -0.5, 0.5)
        return e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] < self.r2

    def _touches_wall(self, pos: torch.Tensor) -> torch.Tensor:
        s = self.spec
        base = torch.floor(pos).to(torch.int64)
        hit = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                tile = base + torch.tensor([di, dj], device=pos.device)
                wall = self.walls[tile[:, 0].clamp(0, s.H - 1), tile[:, 1].clamp(0, s.W - 1)]
                hit = hit | (wall & self._touches(pos, tile))
        return hit

    def step(self, action: torch.Tensor):
        """One action per env; returns (reward, ended, truncated) of the
        moves, after which ended envs hold their next episode's start."""
        s = self.spec
        a = action.to(self.device, torch.int64)
        moving = a < 2
        delta = self.inc * self.dir_table[self.dir]
        cand = torch.where((a == 0)[:, None], self.pos + delta, self.pos - delta)
        hit_goal = moving & self._touches(cand, self.goal)
        hit_wall = moving & self._touches_wall(cand)
        reward = torch.where(hit_goal, self.goal_reward, torch.zeros_like(self.goal_reward))
        commit = moving & ~hit_goal & ~hit_wall
        self.pos = torch.where(commit[:, None], cand, self.pos)
        turn = torch.where(a == 2, 1, torch.where(a == 3, -1, 0))
        self.dir = torch.remainder(self.dir + turn, s.D)
        self.t = self.t + 1
        self.ret = self.ret + reward
        # the step count and return of the finishing move, before a reset
        self.stepped_t, self.stepped_ret = self.t, self.ret
        done = hit_goal
        if s.max_steps > 0:
            truncated = ~done & (self.t >= s.max_steps)
        else:
            truncated = torch.zeros_like(done)
        ended = done | truncated
        self.reward, self.done = reward, ended
        rows = torch.nonzero(ended).flatten().cpu().numpy()
        if rows.size:
            self._reset_rows(rows, self.keys[rows])
        return reward, ended, truncated

    # -- cast and camera view ------------------------------------------------

    def _axis(self, occ_flat, d_main, d_cross, p_main, p_cross, main_is_i):
        """The crossings of one axis's grid lines, all candidates at once:
        (distance f[n, R], main tile, cross tile) of the nearest occupied
        entered tile, the largest float where none is.  At an i-crossing
        a simultaneous j-crossing has advanced, at a j-crossing a
        simultaneous i-crossing has not."""
        s = self.spec
        n_main, n_cross = (s.H, s.W) if main_is_i else (s.W, s.H)
        fl = torch.floor(p_main)                                  # [n, 1]
        main0 = fl.to(torch.int64)
        neg = d_main < 0
        step = torch.where(neg, -1, 1)                            # [n, R]
        frac = p_main - fl
        frac_sel = torch.where(neg, frac, 1.0 - frac)
        ad = torch.abs(d_main)
        k = torch.arange(n_main, device=self.device)
        t = (frac_sel[:, None, :] + k.to(self.dtype)[None, :, None]) / ad[:, None, :]
        finite = torch.isfinite(t)                                # [n, N, R]
        c = torch.where(finite, p_cross[:, :, None] + t * d_cross[:, None, :],
                        torch.zeros_like(t))
        dc = d_cross[:, None, :]
        if main_is_i:
            c_tile = torch.where(dc >= 0, torch.floor(c), torch.ceil(c) - 1.0)
        else:
            c_tile = torch.where(dc > 0, torch.ceil(c) - 1.0, torch.floor(c))
        c_id = torch.clamp(c_tile, 0, n_cross - 1).to(torch.int64)
        m = torch.clamp(main0[:, :, None] + (k[None, :, None] + 1) * step[:, None, :],
                        0, n_main - 1)
        cell = m * s.W + c_id if main_is_i else c_id * s.W + m
        occ = torch.gather(occ_flat, 1, cell.flatten(1)).view(cell.shape) & finite
        tm = torch.where(occ, t, self.big)
        best = tm.amin(dim=1)                                     # [n, R]
        kb = torch.where(tm == best[:, None, :], k[None, :, None], n_main).amin(dim=1)
        c_best = torch.gather(c_id, 1, kb[:, None, :])[:, 0, :]
        return best, main0 + (kb + 1) * step, c_best

    def cast(self, rows: Optional[torch.Tensor] = None):
        """(hit tile int64 [n, R, 2], hit face [n, R] 0 = i / 1 = j,
        distance f[n, R]) of the envs ``rows`` (all where None)."""
        s = self.spec
        pos = self.pos if rows is None else self.pos[rows]
        hd = self.dir if rows is None else self.dir[rows]
        goal = self.goal if rows is None else self.goal[rows]
        n = pos.shape[0]
        rays = self.fan_table[hd]                                 # [n, R, 2]
        occ = self.walls.flatten()[None, :].expand(n, -1).clone()
        occ[torch.arange(n, device=self.device), goal[:, 0] * s.W + goal[:, 1]] = True
        ti, ii, ji = self._axis(occ, rays[..., 0], rays[..., 1], pos[:, 0:1], pos[:, 1:2], True)
        tj, jj, ij = self._axis(occ, rays[..., 1], rays[..., 0], pos[:, 1:2], pos[:, 0:1], False)
        use_j = tj <= ti
        hit = torch.stack([torch.where(use_j, ij, ii), torch.where(use_j, jj, ji)], dim=-1)
        return hit, use_j.to(torch.int64), torch.where(use_j, tj, ti), rays

    def _columns(self, rows=None):
        """Per column, mirrored (column R-1-i shows ray i): (pad int64
        [n, R], slab colour int64 [n, R]).  The column height is
        cam_h * R / (2 sfov * dist * dot(heading, ray)); a height that is
        not finite, or reaches hpu - 1, fills the column."""
        s = self.spec
        hit, face, dist, rays = self.cast(rows)
        hd = self.dir if rows is None else self.dir[rows]
        pd = self.dir_table[hd]
        dot = pd[:, 0:1] * rays[..., 0] + pd[:, 1:2] * rays[..., 1]
        height = self.num / (self.denom * (dist * dot))
        h_pu = torch.where(torch.isfinite(height),
                           torch.floor(torch.clamp(height, max=float(s.hpu))),
                           torch.full_like(height, float(s.hpu))).to(torch.int64)
        pad = torch.where(h_pu >= s.hpu - 1, 0, (s.hpu - h_pu) // 2)
        wall = self.walls[hit[..., 0].clamp(0, s.H - 1), hit[..., 1].clamp(0, s.W - 1)]
        colour = torch.where(wall, torch.where(face == 0, WALL_I, WALL_J),
                             torch.where(face == 0, GOAL_I, GOAL_J))
        return torch.flip(pad, dims=(1,)), torch.flip(colour, dims=(1,))

    def column_sums(self, rows=None) -> torch.Tensor:
        """int64 [n, R]: each camera column's sum of pixel values."""
        pad, colour = self._columns(rows)
        return pad * (CEILING + FLOOR) + (self.spec.hpu - 2 * pad) * colour

    def frames(self, rows=None) -> torch.Tensor:
        """int32 [n, hpu, R] camera views (0x00RRGGBB)."""
        pad, colour = (x.to(torch.int32) for x in self._columns(rows))
        row = torch.arange(self.spec.hpu, dtype=torch.int32, device=self.device)[None, :, None]
        p = pad[:, None, :]
        ceiling, floor = (torch.tensor(c, dtype=torch.int32, device=self.device)
                          for c in (CEILING, FLOOR))
        return torch.where(row < p, ceiling,
                           torch.where(row >= self.spec.hpu - p, floor, colour[:, None, :]))

    def crossings(self, rows=None) -> torch.Tensor:
        """int64 [n]: the grid lines each env's rays cross up to their hits."""
        hit, _, _, _ = self.cast(rows)
        pos = self.pos if rows is None else self.pos[rows]
        start = torch.floor(pos).to(torch.int64)[:, None, :]
        return (hit - start).abs().sum(dim=(1, 2))

    def leaves(self) -> Dict[str, np.ndarray]:
        """The state as host arrays under the port's leaf names."""
        return {
            "goal_tu": self.goal.cpu().numpy(), "pos_wu": self.pos.float().cpu().numpy(),
            "dir_au": self.dir.cpu().numpy(), "rng_key": self.keys.astype(np.int64),
            "t": self.t.cpu().numpy(), "episode_return": self.ret.float().cpu().numpy(),
            "reward": self.reward.float().cpu().numpy(), "done": self.done.cpu().numpy(),
        }
