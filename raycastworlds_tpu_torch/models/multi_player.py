"""MultiPlayerRoom: P players in one walled room, one shared goal.

The state carries a player axis: ``pos_wu`` f[B, P, 2] (the config's float
dtype), ``dir_au`` [B, P] (int32, or float32 under continuous headings),
``reward`` and ``episode_return`` f32[B, P] (float32 in every world, as in
the JAX package); ``done`` stays bool[B] (the episode is the env's).
Actions are int32[B, P] and each observation gains a player axis after the
env axis.

* All players act at once.  A move is tested against the walls, the goal,
  the other players' current circles (2r apart) and the candidates of the
  lower-index players that passed those tests: of two players converging on
  one point the lower index moves.
* Goal contact pays ``goal_reward`` to each scoring player, ends the episode
  and does not move the scorer.
* Each player sees the others as billboard sprites at their positions
  (``player_render="sprite"``), as block tiles at their tiles
  (``"block"``), or not at all (``players_visible=False``).

Every per-player cast folds the player axis into the env axis: one batch
cast of B*P poses serves every player of every env, so the crossing-cast
(or DDA-cast) kernel launches once per observation.  Every env resets from
its own key split in the JAX package's order (next, goal, spawns, headings).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import colors, rng
from ..config import EnvConfig
from ..ops import bitmap, collision, raycast, render, sampling, topview
from ..ops.units import wu_to_pu
from ..state import EnvState
from ..utils import profiling
from .base import Game


@dataclasses.dataclass(frozen=True)
class MultiPlayerConfig(EnvConfig):
    num_players: int = 2
    # Players block each other (circle-circle at 2*player_radius_wu).
    player_collision: bool = True
    # Other players are visible in camera, top and depth observations.
    players_visible: bool = True
    # "sprite": billboard cylinders of radius player_radius_wu and height
    # sprite_height_wu at the players' positions, in the TILE_BLOCK colour;
    # "block": the other players' tiles join the obstacle map and render in
    # the block shades.
    player_render: str = "sprite"
    # Sprite height in world units (a wall is 1 wu tall).
    sprite_height_wu: float = 0.5

    def __post_init__(self):
        super().__post_init__()
        interior = (self.height_tile_map_tu - 2) * (self.width_tile_map_tu - 2)
        if not (1 <= self.num_players < interior):
            raise ValueError(
                f"num_players must be in [1, {interior}) for this map size"
            )
        if self.player_render not in ("sprite", "block"):
            raise ValueError(
                f"unknown player_render: {self.player_render!r} "
                "(expected 'sprite' or 'block')"
            )
        if not (0.0 < self.sprite_height_wu <= self.camera_height_tile_wu * 4):
            raise ValueError("sprite_height_wu must be in (0, 4*camera_height]")

    @property
    def obs_shape(self):
        return (self.num_players,) + super().obs_shape


class MultiPlayerRoom(Game):
    def __init__(self, cfg: MultiPlayerConfig):
        if not isinstance(cfg, MultiPlayerConfig):
            raise TypeError("MultiPlayerRoom requires a MultiPlayerConfig")
        super().__init__(cfg)

    @property
    def action_shape(self):
        return (self.cfg.num_players,)

    @property
    def _sprite_mode(self) -> bool:
        return self.cfg.players_visible and self.cfg.player_render == "sprite"

    # -- reset ----------------------------------------------------------

    def reset_batch(self, keys: torch.Tensor) -> EnvState:
        cfg: MultiPlayerConfig = self.cfg
        h, w, p = cfg.H, cfg.W, cfg.num_players
        dev = keys.device
        b = keys.shape[0]
        sub = rng.split(keys, 4)
        next_key, k_goal, k_spawns, k_dirs = (sub[:, q] for q in range(4))

        goal_tu = sampling.sample_interior_tile(k_goal, h, w)
        # P distinct spawn tiles, each excluding the goal and the earlier ones
        tiles, _ = sampling.sample_distinct_interior_tiles(
            rng.split(k_spawns, p), h, w, [sampling.interior_rank(goal_tu, w)])
        pos_wu, dir_au = self._spawn_pose(tiles, rng.split(k_dirs, p))      # [B, P, 2], [B, P]

        zeros_p = torch.zeros((b, p), dtype=torch.float32, device=dev)
        falses = torch.zeros(b, dtype=torch.bool, device=dev)
        return EnvState(
            wall_words=self._words_batch("border_wall_words", b, dev),
            goal_tu=goal_tu,
            pos_wu=pos_wu,
            dir_au=dir_au,
            reward=zeros_p,
            done=falses,
            rng_key=next_key.contiguous(),
            t=torch.zeros(b, dtype=torch.int32, device=dev),
            episode_return=zeros_p.clone(),
            pending_reset=falses.clone(),
            hw=(h, w),
        )

    # -- step ------------------------------------------------------------

    def step_batch(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """Simultaneous P-player step; ``action`` int32[B, P]."""
        cfg: MultiPlayerConfig = self.cfg
        b, p = action.shape
        r = cfg.player_radius_wu
        dev = state.device
        moving, cand = self._move_candidate(state, action)          # [B, P], [B, P, 2]
        hit_goal = moving & collision.is_colliding_with_goal(
            cand, state.goal_tu[:, None, :], r)
        hit_wall = moving & collision.is_player_colliding_packed(
            state.wall_words.repeat_interleave(p, dim=0), (cfg.H, cfg.W),
            cand.reshape(b * p, 2), r).reshape(b, p)

        if cfg.player_collision:
            thresh = float(cfg.float_dtype((2.0 * r) ** 2))
            # test 1: candidate against the others' current circles
            others = ~torch.eye(p, dtype=torch.bool, device=dev)
            hit_player = moving & (others & (_dist_sq(cand, state.pos_wu) < thresh)).any(dim=-1)
            # test 2: candidate against the lower-index movers' candidates
            # that passed test 1, the walls and the goal
            base_ok = moving & ~hit_goal & ~hit_wall & ~hit_player
            idx = torch.arange(p, device=dev)
            lower = idx[None, :] < idx[:, None]                     # [i, j]: j < i
            hit_cand = (lower & base_ok[:, None, :] & (_dist_sq(cand, cand) < thresh)).any(dim=-1)
            hit_player = hit_player | (moving & hit_cand)
        else:
            hit_player = torch.zeros_like(moving)

        reward = torch.where(
            hit_goal,
            torch.tensor(np.float32(cfg.goal_reward), device=dev),
            torch.tensor(np.float32(0), device=dev),
        )
        ok = moving & ~hit_goal & ~hit_wall & ~hit_player
        return state.replace(
            pos_wu=torch.where(ok[..., None], cand, state.pos_wu),
            dir_au=self._turned_dir(state, action, moving),
            reward=reward,
            done=hit_goal.any(dim=-1),
            t=state.t + 1,
            episode_return=state.episode_return + reward,
        )

    def _move_candidate(self, state: EnvState, action: torch.Tensor):
        """(moving bool[B, P], candidate positions f[B, P, 2])."""
        moving, cand = super()._move_candidate(
            _flat(state), action.reshape(-1))
        return moving.reshape(action.shape), cand.reshape(state.pos_wu.shape)

    # -- observation -----------------------------------------------------

    def _others_tiles(self, state: EnvState) -> torch.Tensor:
        """int32[B, P, P, 2]: for viewer p, every player's tile with row p
        disabled (-1), the tiles p sees as obstacles."""
        tiles = torch.floor(state.pos_wu).to(torch.int32)          # [B, P, 2]
        p = self.cfg.num_players
        own = torch.eye(p, dtype=torch.bool, device=tiles.device)[None, :, :, None]
        return torch.where(own, -1, tiles[:, None, :, :]).to(torch.int32)

    def _viewer_words(self, state: EnvState):
        """(walls, obstacles, blocks) int32[B*P, nw] per viewing player:
        obstacles are the walls and the goal, plus in block mode the other
        players' tiles, which are then also the block words (else None)."""
        p = self.cfg.num_players
        walls, obstacles = (x.repeat_interleave(p, dim=0)
                            for x in self._packed_maps_batch(state))
        blocks = None
        if self.cfg.players_visible and not self._sprite_mode:
            blocks = self._others_words(state)
            obstacles = obstacles | blocks
        return walls, obstacles, blocks

    def _others_words(self, state: EnvState) -> torch.Tensor:
        """int32[B*P, nw] packed tiles of the players each viewer sees."""
        b, p = state.dir_au.shape
        nw = state.wall_words.shape[-1]
        others = self._others_tiles(state).reshape(b * p, p, 2)
        return bitmap.tiles_to_words(others, (self.cfg.H, self.cfg.W), nw)

    @profiling.span("rcw.game.cast_players")
    def _cast_players(self, state: EnvState):
        """(walls, player dirs, hits, t_sprite or None, blocks, positions) of
        every player's view, flattened to [B*P, ...]: one batch cast of B*P
        poses (counted as ``player_views``)."""
        cfg: MultiPlayerConfig = self.cfg
        b, p = state.dir_au.shape
        profiling.count("player_views", b * p)
        walls, obstacles, blocks = self._viewer_words(state)
        flat = _flat(state)
        pos = flat.pos_wu
        hits = raycast.cast_rays(cfg, obstacles, pos, self._ray_dirs(flat))
        t_s = None
        if self._sprite_mode:
            centers = state.pos_wu[:, None, :, :].expand(b, p, p, 2).reshape(b * p, p, 2)
            others = ~torch.eye(p, dtype=torch.bool, device=pos.device)
            t_s = render.ray_circle_t(
                pos, hits.ray_dirs, centers, others.repeat(b, 1),
                cfg.float_dtype(cfg.player_radius_wu ** 2))
        return walls, self._player_dir(flat), hits, t_s, blocks, pos

    def _camera_u32(self, walls, pdir, hits, t_s, blocks, pos) -> torch.Tensor:
        """int32[B*P, H_pu, R] camera views with the sprites drawn; each
        player's textured walls from that player's position ``pos``."""
        cfg: MultiPlayerConfig = self.cfg
        img = render.render_camera_u32(cfg, walls, pdir, hits, block_words=blocks,
                                       pos_wu=pos)
        if t_s is not None:
            img = render.sprite_overlay(cfg, img, pdir, hits, t_s, colors.TILE_BLOCK,
                                        cfg.sprite_height_wu)
        return img

    def observe_batch(self, state: EnvState) -> torch.Tensor:
        cfg: MultiPlayerConfig = self.cfg
        b, p = state.dir_au.shape
        unflat = lambda x: x.reshape((b, p) + tuple(x.shape[1:]))  # noqa: E731
        if cfg.obs_type in ("top_u32", "top_rgb"):
            img = self.top_view_batch(state)
            one = render.u32_to_rgb(img) if cfg.obs_type == "top_rgb" else img
            # the top view is whole-world: the same for every player
            return one[:, None].expand((b, p) + tuple(one.shape[1:]))
        if cfg.obs_type == "tile_grid":
            # tile-resolution by nature: visible players mark their tiles
            # whatever the render mode; no pixel reads the cast
            blocks = self._others_words(state) if cfg.players_visible else None
            return unflat(render.tile_grid(
                cfg, state.wall_words.repeat_interleave(p, dim=0),
                state.goal_tu.repeat_interleave(p, dim=0), blocks))
        walls, pdir, hits, t_s, blocks, pos = self._cast_players(state)
        if cfg.obs_type == "depth":
            if t_s is not None:
                hits = hits._replace(dist_wu=torch.minimum(hits.dist_wu, t_s))
            return unflat(torch.flip(render.projected_depth(pdir, hits), dims=(1,)))
        if cfg.obs_type == "camera_pal8":
            img = render.render_camera_pal8(cfg, walls, pdir, hits, block_words=blocks,
                                            pos_wu=pos)
            if t_s is not None:
                img = render.sprite_overlay(cfg, img, pdir, hits, t_s, colors.PAL_BLOCK,
                                            cfg.sprite_height_wu)
            return unflat(img)
        img = self._camera_u32(walls, pdir, hits, t_s, blocks, pos)
        if cfg.obs_type == "camera_u32":
            return unflat(img.view(torch.uint32))
        if cfg.obs_type == "camera_rgb":
            return unflat(render.u32_to_rgb(img))
        if cfg.obs_type == "camera_gray":
            return unflat(render.u32_to_gray(img))
        if cfg.obs_type == "camera_gray_u8":
            return unflat(render.u32_to_gray_u8(img))
        raise AssertionError(cfg.obs_type)

    def camera_view_batch(self, state: EnvState) -> torch.Tensor:
        """uint32[B, P, H_pu, R] camera views, one per player."""
        b, p = state.dir_au.shape
        img = self._camera_u32(*self._cast_players(state))
        return img.view(torch.uint32).reshape((b, p) + tuple(img.shape[1:]))

    def top_view_batch(self, state: EnvState) -> torch.Tensor:
        """uint32[B, H*ppt, W*ppt] whole-world top views: player 0's rays
        and circle; the other players as filled circles at their positions
        (sprite mode) or as blue tiles (block mode)."""
        cfg: MultiPlayerConfig = self.cfg
        b, p = state.dir_au.shape
        walls, base = self._packed_maps_batch(state)
        blocks = None
        if cfg.players_visible and not self._sprite_mode:
            blocks = self._others_words(state).reshape(b, p, -1)[:, 0]
            base = base | blocks
        first = state.replace(pos_wu=state.pos_wu[:, 0].contiguous(),
                              dir_au=state.dir_au[:, 0])
        hits = raycast.cast_rays(cfg, base, first.pos_wu, self._ray_dirs(first))
        others_pu = None
        if self._sprite_mode and p > 1:
            others_pu = wu_to_pu(state.pos_wu[:, 1:], cfg.pu_per_tu)
        wall_map, block_map = self._maps(walls, blocks)
        return topview.render_top_view(
            cfg, wall_map, state.goal_tu, first.pos_wu, cfg.player_radius_pu, hits,
            block_map=block_map, others_pu=others_pu,
        )


def _flat(state: EnvState) -> EnvState:
    """The pose leaves with the player axis folded into the env axis
    (``pos_wu`` [B*P, 2], ``dir_au`` [B*P]), for the per-env helpers."""
    return state.replace(pos_wu=state.pos_wu.reshape(-1, 2),
                         dir_au=state.dir_au.reshape(-1))


def _dist_sq(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32[B, P, Q]: squared distance of each a[:, i] (f32[B, P, 2]) to each
    c[:, j] (f32[B, Q, 2]), the sum of the two squared differences."""
    sq = (a[:, :, None, :] - c[:, None, :, :]) ** 2
    return sq[..., 0] + sq[..., 1]


def make(cfg: MultiPlayerConfig | None = None, **kw) -> MultiPlayerRoom:
    return MultiPlayerRoom(cfg if cfg is not None else MultiPlayerConfig(**kw))
