"""Game base class: the batched step / cast / observe shared by the world
families.  A ``Game`` carries the static ``EnvConfig`` and per-device copies
of its lookup tables; all dynamics are functions of ``(EnvState, action)``
over the leading env axis.  Subclasses provide ``reset_batch`` and override
the hooks their world needs: ``step_batch``, ``_packed_maps_batch`` (the
obstacle union), ``_block_words_batch`` (tiles rendered in the block
shades) and, for border-ring + unit-box maps, ``supports_analytic_raycast``
with ``_analytic_boxes``.  The single-env API (``reset_single``,
``step_single``, ``observe_single``, ...) is the batch API at one env, for
every family.

Headings are int32 angle units read through the config's direction and
ray-fan tables, or, under ``continuous_heading``, float32 angle units whose
direction (correctly rounded cos/sin, ``render.cos_f32``) and ray fan
(``raycast.ray_fan``) are computed live.  Positions, and the rewards of the
single-player families after their first step, have the config's float
dtype (``EnvConfig.dtype``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import ACTION_NAMES, MOVE_FORWARD, TURN_LEFT, TURN_RIGHT, EnvConfig
from ..ops import bitmap, collision, lut, raycast, raycast_analytic, render, sampling
from ..ops import raycast_crossing_kernel as rck
from ..ops import render_fused, topview
from ..state import EnvState, default_device
from ..utils import profiling


class Game:
    """Base game over the generic grid-world dynamics."""

    num_actions = 4
    # Trailing per-env action shape: () for single-player families.
    action_shape: tuple = ()

    def __init__(self, cfg: EnvConfig):
        self.cfg = cfg
        # torch dtype of positions and ray math (EnvConfig.dtype)
        self.float_dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
        self._tables: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    def _table(self, name: str, device: torch.device) -> torch.Tensor:
        """The config's host LUT ``name`` as a tensor on ``device`` (uint32
        tables, packed words, as their int32 bit patterns)."""
        key = (name, device)
        if key not in self._tables:
            host = np.ascontiguousarray(getattr(self.cfg, name))
            if host.dtype == np.uint32:
                host = host.view(np.int32)
            self._tables[key] = torch.from_numpy(host).to(device)
        return self._tables[key]

    def _words_batch(self, name: str, b: int, device: torch.device) -> torch.Tensor:
        """The config's packed words ``name`` for each of ``b`` envs."""
        return self._table(name, device)[None, :].expand(b, -1).contiguous()

    # -- per-family -----------------------------------------------------

    def reset_batch(self, keys: torch.Tensor) -> EnvState:
        """Fresh states from per-env keys int64[B, 2]."""
        raise NotImplementedError

    # -- heading --------------------------------------------------------

    def _player_dir(self, state: EnvState) -> torch.Tensor:
        """Heading vectors f[B, 2] of ``state.dir_au`` [B]."""
        if self.cfg.continuous_heading:
            ang = state.dir_au.to(self.float_dtype)
            ang = ang * torch.tensor(2.0 * math.pi / self.cfg.num_directions,
                                     dtype=ang.dtype, device=ang.device)
            if ang.dtype == torch.float32:
                return torch.stack([render.cos_f32(ang), render.sin_f32(ang)], dim=-1)
            return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
        return lut.take_rows(self._table("directions_wu", state.device), state.dir_au)

    def _ray_dirs(self, state: EnvState, flipped: bool = False) -> torch.Tensor:
        """Ray fans f[B, R, 2] of the headings, in cast order or, ``flipped``,
        in column order."""
        if self.cfg.continuous_heading:
            fan = raycast.ray_fan(self.cfg, self._player_dir(state))
            return torch.flip(fan, dims=(1,)) if flipped else fan
        name = "ray_fan_lut_flipped" if flipped else "ray_fan_lut"
        return lut.take_rows(self._table(name, state.device), state.dir_au)

    def _spawn_pose(self, spawn_tu: torch.Tensor, k_dir: torch.Tensor):
        """(pos_wu, dir_au) of a reset: the spawn tiles' centres in the
        float dtype and headings drawn from ``k_dir`` (one per tile)."""
        cfg = self.cfg
        heading = sampling.sample_heading(k_dir, cfg.num_directions, cfg.continuous_heading)
        return spawn_tu.to(self.float_dtype) + 0.5, heading

    # -- shared dynamics ------------------------------------------------

    def step_batch(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """One action per env, branch-free:

        * actions 0/1 translate along the heading vector; the candidate
          position is tested against the goal and the walls separately; a
          goal hit pays ``goal_reward`` and terminates without moving; a
          wall hit blocks; otherwise the move commits.
        * actions 2/3 turn by +/-1 angle unit, modular.
        * ``done``/``reward`` are re-derived every step (not sticky).
        """
        moving, cand = self._move_candidate(state, action)
        return self._goal_step(state, action, moving, cand, state.wall_words)

    def _goal_step(self, state: EnvState, action, moving, cand, solid_words,
                   stop=None) -> EnvState:
        """The single-goal step of a move to ``cand``: the goal pays and
        terminates, ``solid_words`` (int32[B, nw]) and ``stop`` (bool[B]
        contacts, or None) block, anything else commits."""
        cfg = self.cfg
        r = cfg.player_radius_wu
        hit_goal = moving & collision.is_colliding_with_goal(cand, state.goal_tu, r)
        hit_wall = moving & collision.is_player_colliding_packed(
            solid_words, (cfg.H, cfg.W), cand, r
        )
        reward = torch.where(hit_goal, self._reward_const(cfg.goal_reward, state),
                             self._reward_const(0, state))
        commit = moving & ~hit_goal & ~hit_wall
        if stop is not None:
            commit = commit & ~stop
        return state.replace(
            pos_wu=torch.where(commit[:, None], cand, state.pos_wu),
            dir_au=self._turned_dir(state, action, moving),
            reward=reward,
            done=hit_goal,
            t=state.t + 1,
            episode_return=state.episode_return + reward,
        )

    def _reward_const(self, value, state: EnvState) -> torch.Tensor:
        """``value`` as a 0-dim tensor of the position dtype."""
        return torch.tensor(float(value), dtype=state.pos_wu.dtype, device=state.device)

    def _move_candidate(self, state: EnvState, action: torch.Tensor):
        """(moving bool[B], candidate position f[B, 2])."""
        dir_wu = self._player_dir(state)
        moving = action < 2
        sign = torch.where(action == MOVE_FORWARD, 1.0, -1.0).to(state.pos_wu.dtype)
        inc = sign * float(self.cfg.float_dtype(self.cfg.position_increment_wu))
        return moving, state.pos_wu + inc[:, None] * dir_wu

    def _turned_dir(self, state: EnvState, action: torch.Tensor, moving):
        """New heading after a turn action: +/-1 angle unit, or, under
        continuous headings, +/-``turn_increment_au`` in the heading's float
        dtype; modulo the angle units either way."""
        turn = torch.where(
            action == TURN_LEFT, 1, torch.where(action == TURN_RIGHT, -1, 0)
        )
        d = self.cfg.num_directions
        if not self.cfg.continuous_heading:
            step = torch.where(moving, 0, turn)
            return torch.remainder(state.dir_au + step, d).to(torch.int32)
        dt = state.dir_au.dtype
        inc = torch.tensor(float(self.cfg.turn_increment_au), dtype=dt, device=state.device)
        step = torch.where(moving, torch.zeros((), dtype=dt, device=state.device),
                           turn.to(dt) * inc)
        return torch.remainder(state.dir_au + step,
                               torch.tensor(float(d), dtype=dt, device=state.device))

    def _tile_word(self, tile_tu: torch.Tensor, nw: int) -> torch.Tensor:
        """int32[B, nw] one-hot packed word of one tile per env."""
        idx = tile_tu[:, 0] * self.cfg.W + tile_tu[:, 1]
        lane = torch.arange(nw, dtype=torch.int32, device=idx.device)[None, :]
        return torch.where(
            lane == (idx[:, None] >> 5),
            torch.ones_like(idx)[:, None] << (idx[:, None] & 31),
            0,
        ).to(torch.int32)

    def _packed_maps_batch(self, state: EnvState):
        """(wall_words, obstacle_words) int32[B, nw]: the obstacle map is
        the walls plus the goal bit."""
        wall_words = state.wall_words
        return wall_words, wall_words | self._tile_word(state.goal_tu, wall_words.shape[-1])

    def _block_words_batch(self, state: EnvState):
        """Packed words i32[B, nw] of the tiles rendered in the block shades,
        or None for a world without them."""
        return None

    # Worlds that are exactly border ring + K unit boxes (SingleRoom,
    # MultiGoalRoom, DynamicRoom) can take the closed-form cast.
    supports_analytic_raycast: bool = False

    def _analytic_boxes(self, state: EnvState) -> torch.Tensor:
        """int32[B, K, 2] box tiles of the analytic cast; rows outside the
        interior are disabled slots."""
        return state.goal_tu[:, None, :]

    @profiling.span("rcw.game.cast_batch")
    def cast_batch(self, state: EnvState) -> raycast.RayHits:
        """Ray-cast every env's pose through the backend the config resolves
        for the state's device; ``analytic`` takes the closed-form cast where
        the family supports it and the scan elsewhere."""
        if self.supports_analytic_raycast and self.cfg.raycast_backend == "analytic":
            return raycast_analytic.cast_rays_boxes(
                self.cfg, self._analytic_boxes(state), state.pos_wu,
                self._ray_dirs(state),
            )
        _, obstacle_words = self._packed_maps_batch(state)
        return raycast.cast_rays(
            self.cfg, obstacle_words, state.pos_wu, self._ray_dirs(state)
        )

    def _use_fused(self) -> bool:
        """The DDA + u32 render kernel: flat-shaded float32 camera_u32, rgb
        and gray views (rgb and gray are conversions of its image).  Textured
        walls render after a cast, as in the JAX package."""
        cfg = self.cfg
        return (
            cfg.raycast_backend == "fused"
            and cfg.obs_type in ("camera_u32", "camera_rgb", "camera_gray")
            and cfg.wall_texture == "none"
            and cfg.dtype == "float32"
        )

    def _use_kernel_pal8(self, state: EnvState) -> bool:
        """The crossing cast + pal8 render kernel: flat-shaded float32 pal8
        views of worlds with one goal tile and no blocks, whose slab colour
        it decides by equality of the hit tile with the goal tile."""
        cfg = self.cfg
        return (
            cfg.raycast_backend == "crossing_kernel_fused"
            and cfg.obs_type == "camera_pal8"
            and cfg.wall_texture == "none"
            and cfg.dtype == "float32"
            and not cfg.continuous_heading
            and state.goal_words is None
            and self._block_words_batch(state) is None
        )

    def observe_batch(self, state: EnvState) -> torch.Tensor:
        cfg = self.cfg
        if cfg.obs_type in ("top_u32", "top_rgb"):
            img = self.top_view_batch(state)
            return render.u32_to_rgb(img) if cfg.obs_type == "top_rgb" else img
        if cfg.obs_type == "tile_grid":  # no pixel of it reads the cast
            return render.render_observation(
                cfg, state.wall_words, state.goal_tu, None, None,
                block_words=self._block_words_batch(state), goal_words=state.goal_words,
            )
        if self._use_kernel_pal8(state):
            _, obstacle_words = self._packed_maps_batch(state)
            return rck.cast_render_pal8_kernel(
                obstacle_words, (cfg.H, cfg.W), state.pos_wu,
                self._ray_dirs(state, flipped=True), self._player_dir(state),
                state.goal_tu, cfg.height_camera_view_pu,
                *render.render_constants(cfg),
            )
        if self._use_fused():
            wall_words, obstacle_words = self._packed_maps_batch(state)
            img = render_fused.render_camera_fused_batched(
                obstacle_words, wall_words, (cfg.H, cfg.W), state.pos_wu,
                self._player_dir(state), self._ray_dirs(state, flipped=True),
                cfg.dda_steps, cfg.height_camera_view_pu,
                *render.render_constants(cfg),
                block_words=self._block_words_batch(state),
            )
            if cfg.obs_type == "camera_rgb":
                return render.u32_to_rgb(img)
            if cfg.obs_type == "camera_gray":
                return render.u32_to_gray(img)
            return img.view(torch.uint32)
        return self._observe_from_hits(state, self.cast_batch(state))

    def _observe_from_hits(self, state: EnvState, hits: raycast.RayHits) -> torch.Tensor:
        """The observations of ``state`` rendered from its casts ``hits``."""
        return render.render_observation(
            self.cfg, state.wall_words, state.goal_tu, self._player_dir(state), hits,
            block_words=self._block_words_batch(state), goal_words=state.goal_words,
            pos_wu=state.pos_wu,
        )

    def _maps(self, *words):
        """Dense bool[B, H, W] maps of packed words, None for None."""
        shape = (self.cfg.H, self.cfg.W)
        return [None if w is None else bitmap.unpack_bits(w, shape) for w in words]

    def top_view_batch(self, state: EnvState) -> torch.Tensor:
        """uint32[B, H*ppt, W*ppt] top views (:func:`topview.render_top_view`):
        goal words and block words as the world has them."""
        cfg = self.cfg
        walls, goals, blocks = self._maps(
            state.wall_words, state.goal_words, self._block_words_batch(state))
        return topview.render_top_view(
            cfg, walls, state.goal_tu, state.pos_wu, cfg.player_radius_pu,
            self.cast_batch(state), goal_map=goals, block_map=blocks,
        )

    def camera_view_batch(self, state: EnvState) -> torch.Tensor:
        """uint32[B, H_pu, R] camera views whatever the ``obs_type``."""
        img = render.render_camera_u32(
            self.cfg, state.wall_words, self._player_dir(state), self.cast_batch(state),
            block_words=self._block_words_batch(state), pos_wu=state.pos_wu,
        )
        return img.view(torch.uint32)

    # -- one env ----------------------------------------------------------
    # A single-env state has the batch leaves without the env axis
    # (``pos_wu`` f[2], ``dir_au`` [], MultiPlayerRoom's ``pos_wu`` f[P, 2]).
    # Each method below is its batch method at B=1: the same backend
    # dispatch, so on the card the same kernel at one env.  The JAX package
    # casts one env by the XLA crossing instead; every kernel equals its
    # plain version bit for bit, so that is a choice of kernel, not of
    # result.

    def reset_single(self, key: torch.Tensor, device=None) -> EnvState:
        """A fresh state from one key int64[2] on ``device``: row k of
        ``reset_batch`` for the k-th key.  As ``Env``, ``device=None`` is
        the CUDA device and raises where there is none; the CPU runs only
        when asked for (``device="cpu"``, or ``state.device`` to re-reset
        from a state's ``rng_key`` where that state lies).  The other
        single methods run where their state lies."""
        key = key.to(default_device(device, "reset_single"))
        return self.reset_batch(key[None]).unbatch()

    def step_single(self, state: EnvState, action) -> EnvState:
        """One action (int32[], or int32[P] for MultiPlayerRoom)."""
        action = torch.as_tensor(action, dtype=torch.int32, device=state.device)
        return self.step_batch(state.batch1(), action[None]).unbatch()

    def cast_single(self, state: EnvState) -> raycast.RayHits:
        """The rays of the current pose, ``RayHits`` of [R, ...]."""
        return raycast.RayHits(*(x[0] for x in self.cast_batch(state.batch1())))

    def observe_from_hits_single(self, state: EnvState, hits: raycast.RayHits) -> torch.Tensor:
        """The observation rendered from the casts ``hits`` ([R, ...])."""
        hits = raycast.RayHits(*(x[None] for x in hits))
        return self._observe_from_hits(state.batch1(), hits)[0]

    def observe_single(self, state: EnvState) -> torch.Tensor:
        return self.observe_batch(state.batch1())[0]

    def top_view_single(self, state: EnvState) -> torch.Tensor:
        """uint32[H*ppt, W*ppt] top view."""
        return self.top_view_batch(state.batch1())[0]

    def camera_view_single(self, state: EnvState) -> torch.Tensor:
        """uint32 camera view whatever the ``obs_type``."""
        return self.camera_view_batch(state.batch1())[0]

    def action_names(self):
        return ACTION_NAMES
