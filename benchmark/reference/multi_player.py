"""Plain reference of the MultiPlayerRoom world, batched over envs in plain
torch, with 0x00RRGGBB camera frames and billboard sprites.

The room, the moves, the goal, the cast and the camera columns are
SingleRoom's (``single_room.World``); P players share each env's room and
goal.  The semantics are the project's published multi-player rules (the
JAX package's ``models/multi_player.py`` and its scalar oracle
``OracleMultiPlayer``):

* reset: ``split(key, 4)`` -> next, goal, spawns, headings, in that order.
  The goal is uniform over the interior (SingleRoom's draw).  The spawns
  key is split in P; player i's tile is the k-th interior tile of a
  row-major count with the goal and players 0..i-1 taken out, by one
  float32 uniform u over the n = (H-2)(W-2) - 1 - i tiles left,
  k = clip(floor(u * n), 0, max(n - 1, 0)); the player stands at its
  centre.  The headings key is split in P; player i's heading is uniform
  over the ``num_directions`` angle units;
* step: every player acts at once from the same state.  A move's
  candidate circle is tested against the walls and the goal (SingleRoom's
  tests), then, with ``player_collision``, against the other players'
  current circles (squared centre distance under (2r)**2), then against
  the candidates of the lower-index players that passed every test before
  it: of two players converging on one point the lower index moves.  A
  player whose candidate touches the goal earns ``goal_reward``, stays
  where it stands, and ends the env's episode; every other blocked move
  leaves the player in place; turns turn.  An env whose episode ends
  resets whole in the same step from its key; the rewards and the end
  flag of the finishing move stay on the reset state;
* frames: each player's cast sees the walls and the goal only, from its
  own pose (SingleRoom's camera columns).  With ``players_visible`` and
  ``player_render`` "sprite", each other player is a billboard cylinder of
  radius r at its position: along ray d from the viewer's position p, with
  o = c - p, b = d.o, disc = (b*b - o.o) + r*r, the near root
  t = b - sqrt(disc) where disc >= 0 and t > 0, the nearest over the other
  players.  Where t is under the ray's wall distance, the column shows the
  sprite: from the bottom of a wall column at t (the pad rule of the wall
  columns, at the height cam_h * R / (2 sfov * t * dot(heading, ray)))
  up ``sprite_height_wu`` of that height, clipped to the frame, in
  ``TILE_BLOCK``.

Departures from the JAX package, none of which changes a result: a spawn
is the k-th empty tile of a count with the goal and the earlier spawns
filled in, where the JAX package bumps the rank k past each excluded rank
in ascending order (the same tile by the order-statistics identity); every
float operation rounds alone (XLA on the CPU may fuse a multiply and an
add), and the square root is the float64 root rounded to ``dtype``, which
is the correctly rounded one; the heading is discrete only; geometry runs
in ``dtype`` (float32 for the configuration, lower for the control); block
rendering (``player_render`` "block") is not implemented.

The check keeps one reward total per env, so ``World.step`` returns each
env's rewards summed over its players; the per-player rewards are held by
the ``reward`` and ``episode_return`` leaves ([B, P]).  ``column_sums`` is
[B, P, R] and ``frames`` [n, P, H, R], int32.  Nothing here comes from the
code under test.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import threefry
from .single_room import CEILING, FLOOR
from .single_room import Spec as SingleRoomSpec
from .single_room import World as SingleRoomWorld

__all__ = ["Spec", "World", "reset_draws", "TILE_BLOCK"]

# 0x00RRGGBB of a sprite (the pure-blue block colour).
TILE_BLOCK = 0x0000FF


class Spec(SingleRoomSpec):
    """The sizes and player rules of one configuration's ``env`` block."""

    def __init__(self, env: Dict):
        super().__init__(env)
        self.P = int(env["num_players"])
        self.collision = bool(env["player_collision"])
        if env["player_render"] != "sprite":
            raise ValueError("the reference renders players as sprites only, not "
                             f"{env['player_render']!r}")
        self.sprites = bool(env["players_visible"])
        self.sprite_h = float(env["sprite_height_wu"])


def kth_interior(u: np.ndarray, taken: np.ndarray) -> np.ndarray:
    """int64 [n, 2]: per env, the k-th interior tile not ``taken`` (bool
    [n, H, W]) in row-major order, k = clip(floor(u * m), 0, max(m - 1, 0))
    for the m tiles left and the float32 uniform ``u`` [n]."""
    n, h, w = taken.shape
    free = ~taken
    free[:, [0, -1], :] = False
    free[:, :, [0, -1]] = False
    count = np.cumsum(free.reshape(n, -1), axis=1)
    m = count[:, -1]
    k = np.floor(u * m.astype(np.float32)).astype(np.int64)
    k = np.minimum(np.maximum(k, 0), np.maximum(m - 1, 0))
    idx = np.argmax(count > k[:, None], axis=1)
    return np.stack([idx // w, idx % w], axis=-1)


def reset_draws(spec: Spec, keys: np.ndarray):
    """The reset of each env from its key (uint32 [n, 2]): (next key
    [n, 2], goal tile int64 [n, 2], spawn tiles int64 [n, P, 2], headings
    int64 [n, P])."""
    n, p = keys.shape[0], spec.P
    sub = threefry.split(keys, 4)
    nxt, k_goal, k_spawns, k_dirs = (sub[:, q] for q in range(4))
    goal = threefry.randint(k_goal, 2, [1, 1], [spec.H - 1, spec.W - 1])
    taken = np.zeros((n, spec.H, spec.W), dtype=bool)
    envs = np.arange(n)
    taken[envs, goal[:, 0], goal[:, 1]] = True
    u = threefry.uniform(threefry.split(k_spawns, p))               # [n, P]
    spawns = np.zeros((n, p, 2), dtype=np.int64)
    for i in range(p):
        spawns[:, i] = kth_interior(u[:, i], taken)
        taken[envs, spawns[:, i, 0], spawns[:, i, 1]] = True
    headings = threefry.randint(threefry.split(k_dirs, p), 1, 0, spec.D)[..., 0]
    return nxt, goal, spawns, headings


class _Views(SingleRoomWorld):
    """Every player's view as an env of its own (the player axis folded
    into the env axis); keeps the hits of its last cast."""

    def cast(self, rows=None):
        self.hits = super().cast(rows)
        return self.hits


class World(SingleRoomWorld):
    """``num_envs`` MultiPlayerRoom envs of P players stepped in lockstep
    with dense auto-reset, on ``device``, geometry in ``dtype``.  The keys
    live on the host (``keys``, uint32 [B, 2]); the rest of the state is
    tensors: ``pos`` [B, P, 2], ``dir``, ``reward`` and ``ret`` [B, P],
    ``goal`` [B, 2], ``t`` and ``done`` [B]; ``yielded`` [B, P] marks the
    moves of the last step that the lower-index rule alone blocked."""

    def __init__(self, env: Dict, num_envs: int, device, dtype=torch.float32):
        super().__init__(env, num_envs, device, dtype)
        self.spec = s = Spec(env)
        self.views = _Views(env, num_envs * s.P, device, dtype)
        self.thresh = torch.tensor((2.0 * s.radius) ** 2, dtype=dtype, device=self.device)
        self.sprite_h = torch.tensor(s.sprite_h, dtype=dtype, device=self.device)
        idx = torch.arange(s.P, device=self.device)
        self.others = idx[:, None] != idx[None, :]                # [i, j]: j is not i
        self.lower = idx[None, :] < idx[:, None]                  # [i, j]: j below i
        self.around = torch.tensor([[di, dj] for di in (-1, 0, 1) for dj in (-1, 0, 1)],
                                   device=self.device)

    # -- reset and step ---------------------------------------------------

    def reset(self, keys: np.ndarray) -> None:
        """Every env from its own key (uint32 [B, 2])."""
        b, p, dev = self.B, self.spec.P, self.device
        self.goal = torch.zeros((b, 2), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((b, p, 2), dtype=self.dtype, device=dev)
        self.dir = torch.zeros((b, p), dtype=torch.int64, device=dev)
        self.t = torch.zeros(b, dtype=torch.int64, device=dev)
        self.ret = torch.zeros((b, p), dtype=self.dtype, device=dev)
        self.reward = torch.zeros((b, p), dtype=self.dtype, device=dev)
        self.done = torch.zeros(b, dtype=torch.bool, device=dev)
        self.yielded = torch.zeros((b, p), dtype=torch.bool, device=dev)
        self.stepped_t, self.stepped_ret = self.t, self.ret
        self._reset_rows(np.arange(b), keys)

    def _reset_rows(self, rows: np.ndarray, keys: np.ndarray) -> None:
        nxt, goal, spawns, headings = reset_draws(self.spec, keys)
        dev = self.device
        self.keys[rows] = nxt
        idx = torch.from_numpy(rows).to(dev)
        # out of place: a state handed out earlier keeps its values
        self.goal = self.goal.index_copy(0, idx, torch.from_numpy(goal).to(dev))
        self.pos = self.pos.index_copy(
            0, idx, torch.from_numpy(spawns).to(dev, self.dtype) + self.half)
        self.dir = self.dir.index_copy(0, idx, torch.from_numpy(headings).to(dev))
        self.t = self.t.index_fill(0, idx, 0)
        self.ret = self.ret.index_fill(0, idx, 0)

    def _touches_wall(self, pos: torch.Tensor) -> torch.Tensor:
        """SingleRoom's wall test (the circle at ``pos`` f[n, 2] overlaps a
        wall among the 3 x 3 tiles around its own), the nine tiles at once."""
        s = self.spec
        tiles = torch.floor(pos).to(torch.int64)[:, None, :] + self.around   # [n, 9, 2]
        wall = self.walls[tiles[..., 0].clamp(0, s.H - 1), tiles[..., 1].clamp(0, s.W - 1)]
        return (wall & self._touches(pos[:, None, :], tiles)).any(dim=1)

    def _dist_sq(self, a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """[B, P, P]: the squared distance of a[:, i] to c[:, j]."""
        d = a[:, :, None, :] - c[:, None, :, :]
        return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]

    def step(self, action: torch.Tensor):
        """One action per player, int [B, P]; returns (each env's rewards
        summed over its players [B], ended [B], truncated [B]) of the
        moves, after which ended envs hold their next episode's start."""
        s = self.spec
        b, p = self.B, s.P
        a = action.to(self.device, torch.int64)
        moving = a < 2
        delta = self.inc * self.dir_table[self.dir]                # [B, P, 2]
        cand = torch.where((a == 0)[..., None], self.pos + delta, self.pos - delta)
        hit_goal = moving & self._touches(cand, self.goal[:, None, :])
        hit_wall = moving & self._touches_wall(cand.reshape(b * p, 2)).reshape(b, p)
        blocked = hit_goal | hit_wall
        if s.collision:
            near = self._dist_sq(cand, self.pos) < self.thresh
            hit_player = moving & (self.others & near).any(dim=-1)
            passed = moving & ~blocked & ~hit_player
            converging = self._dist_sq(cand, cand) < self.thresh
            yielded = passed & (self.lower & passed[:, None, :] & converging).any(dim=-1)
            self.yielded = yielded
            blocked = blocked | hit_player | yielded
        reward = torch.where(hit_goal, self.goal_reward, torch.zeros_like(self.goal_reward))
        commit = moving & ~blocked
        self.pos = torch.where(commit[..., None], cand, self.pos)
        turn = torch.where(a == 2, 1, torch.where(a == 3, -1, 0))
        self.dir = torch.remainder(self.dir + turn, s.D)
        self.t = self.t + 1
        self.ret = self.ret + reward
        # the step count and returns of the finishing move, before a reset
        self.stepped_t, self.stepped_ret = self.t, self.ret
        done = hit_goal.any(dim=-1)
        if s.max_steps > 0:
            truncated = ~done & (self.t >= s.max_steps)
        else:
            truncated = torch.zeros_like(done)
        ended = done | truncated
        self.reward, self.done = reward, ended
        rows = torch.nonzero(ended).flatten().cpu().numpy()
        if rows.size:
            self._reset_rows(rows, self.keys[rows])
        return reward.sum(dim=-1), ended, truncated

    # -- camera view -------------------------------------------------------

    def _sprite_t(self, rows: Optional[torch.Tensor], rays: torch.Tensor) -> torch.Tensor:
        """f[n, P, R]: along each player's (cast-order) rays ``rays``
        [n * P, R, 2], the near distance to the nearest other player's
        circle, the largest float where it misses them all."""
        pos = self.pos if rows is None else self.pos[rows]        # [n, P, 2]
        n, p = pos.shape[:2]
        d = rays.reshape(n, p, 1, -1, 2)                          # [n, i, 1, R, 2]
        o = (pos[:, None, :, :] - pos[:, :, None, :])[:, :, :, None, :]  # [n, i, j, 1, 2]
        b = d[..., 0] * o[..., 0] + d[..., 1] * o[..., 1]          # [n, i, j, R]
        c2 = o[..., 0] * o[..., 0] + o[..., 1] * o[..., 1]
        disc = (b * b - c2) + self.r2
        root = torch.sqrt(torch.clamp(disc, min=0).to(torch.float64)).to(self.dtype)
        t = b - root
        hit = self.others[None, :, :, None] & (disc >= 0) & (t > 0)
        return torch.where(hit, t, self.big).amin(dim=2)

    def _columns(self, rows=None):
        """Per column, mirrored, each [n, P, R]: (wall pad, slab colour,
        sprite shown, sprite top row, sprite bottom row), int64 and bool."""
        s = self.spec
        pos = self.pos if rows is None else self.pos[rows]
        n, p = pos.shape[:2]
        v = self.views
        v.pos = pos.reshape(n * p, 2)
        v.dir = (self.dir if rows is None else self.dir[rows]).reshape(n * p)
        v.goal = (self.goal if rows is None else self.goal[rows]).repeat_interleave(p, dim=0)
        pad, colour = SingleRoomWorld._columns(v)
        _, _, dist, rays = v.hits
        unfold = lambda x: x.reshape(n, p, -1)  # noqa: E731
        shown = torch.zeros((n, p, s.R), dtype=torch.bool, device=self.device)
        top = bottom = torch.zeros((n, p, s.R), dtype=torch.int64, device=self.device)
        if s.sprites:
            t = self._sprite_t(rows, rays)
            shown = t < unfold(dist)
            pd = self.dir_table[v.dir]
            dot = pd[:, 0:1] * rays[..., 0] + pd[:, 1:2] * rays[..., 1]
            height = self.num / (self.denom * (t * unfold(dot)))
            height = torch.where(shown & torch.isfinite(height), height, torch.zeros_like(height))
            h_pu = torch.floor(torch.clamp(height, max=float(s.hpu))).to(torch.int64)
            bottom = s.hpu - torch.where(h_pu >= s.hpu - 1, 0, (s.hpu - h_pu) // 2)
            tall = torch.floor(torch.clamp(self.sprite_h * height, max=float(s.hpu)))
            top = torch.clamp(bottom - tall.to(torch.int64), min=0)
            shown, top, bottom = (torch.flip(x, dims=(2,)) for x in (shown, top, bottom))
        return unfold(pad), unfold(colour), shown, top, bottom

    def column_sums(self, rows=None) -> torch.Tensor:
        """int64 [n, P, R]: each camera column's sum of pixel values."""
        hpu = self.spec.hpu
        pad, colour, shown, top, bottom = self._columns(rows)
        sums = pad * (CEILING + FLOOR) + (hpu - 2 * pad) * colour

        # the sprite's rows [top, bottom) over the ceiling [0, pad), the slab
        # [pad, hpu - pad) and the floor [hpu - pad, hpu)
        over_ceiling = torch.clamp(torch.minimum(bottom, pad) - top, min=0)
        over_floor = torch.clamp(bottom - torch.maximum(top, hpu - pad), min=0)
        over_slab = bottom - top - over_ceiling - over_floor
        over = (over_ceiling * (TILE_BLOCK - CEILING) + over_slab * (TILE_BLOCK - colour)
                + over_floor * (TILE_BLOCK - FLOOR))
        return sums + torch.where(shown, over, 0)

    def frames(self, rows=None) -> torch.Tensor:
        """int32 [n, P, hpu, R] camera views (0x00RRGGBB)."""
        pad, colour, shown, top, bottom = (x.to(torch.int32) if x.dtype != torch.bool else x
                                           for x in self._columns(rows))
        row = torch.arange(self.spec.hpu, dtype=torch.int32, device=self.device)[:, None]
        p = pad[..., None, :]
        ceiling, floor, block = (torch.tensor(c, dtype=torch.int32, device=self.device)
                                 for c in (CEILING, FLOOR, TILE_BLOCK))
        img = torch.where(row < p, ceiling,
                          torch.where(row >= self.spec.hpu - p, floor, colour[..., None, :]))
        sprite = shown[..., None, :] & (row >= top[..., None, :]) & (row < bottom[..., None, :])
        return torch.where(sprite, block, img)
