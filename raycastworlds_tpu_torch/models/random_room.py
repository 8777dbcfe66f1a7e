"""RandomRoom: a new random obstacle map per episode.

Border walls plus Bernoulli interior walls, the goal on an empty interior
tile (cleared even where the noise walled it), and the spawn drawn only
from tiles reachable from the goal by a flood fill, so every episode is
winnable.  Dynamics are SingleRoom's.  Every env resets from its own key
split in the JAX package's order (next, map, goal, spawn, heading).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import rng
from ..config import EnvConfig
from ..ops import bitmap, flood, sampling
from ..state import EnvState
from .base import Game


@dataclasses.dataclass(frozen=True)
class RandomRoomConfig(EnvConfig):
    """EnvConfig + obstacle density (fraction of interior tiles walled).

    ``flood_iters`` is the reachability fill's iteration budget (<= 0: the
    exact bound ``H*W//2 + 2``; fewer iterations only shrink the spawn set).
    ``ensure_reachable=False`` skips the fill and spawns on any empty tile.
    """

    wall_density: float = 0.2
    flood_iters: int = -1
    ensure_reachable: bool = True

    def __post_init__(self):
        super().__post_init__()
        if not (0.0 <= self.wall_density < 1.0):
            raise ValueError("wall_density must be in [0, 1)")
        if self.height_tile_map_tu < 5 or self.width_tile_map_tu < 5:
            raise ValueError(
                "RandomRoom needs at least a 5x5 map (enclosed-goal spawn "
                "fallback requires a 3x3+ interior)"
            )


def _without(mask: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
    """``mask`` bool[B, H, W] with each env's ``tile`` (i32[B, 2]) False."""
    _, h, w = mask.shape
    ii = torch.arange(h, device=tile.device)[None, :, None]
    jj = torch.arange(w, device=tile.device)[None, None, :]
    hit = (ii == tile[:, 0, None, None]) & (jj == tile[:, 1, None, None])
    return mask & ~hit


class RandomRoom(Game):
    def __init__(self, cfg: RandomRoomConfig):
        if not isinstance(cfg, RandomRoomConfig):
            cfg = RandomRoomConfig(**dataclasses.asdict(cfg))
        super().__init__(cfg)

    def reset_batch(self, keys: torch.Tensor) -> EnvState:
        cfg: RandomRoomConfig = self.cfg
        h, w = cfg.H, cfg.W
        dev = keys.device
        b = keys.shape[0]
        sub = rng.split(keys, 5)
        next_key, k_map, k_goal, k_spawn, k_dir = (sub[:, q] for q in range(5))

        border = self._table("border_wall_map", dev)
        wall_map = border | rng.bernoulli(k_map, cfg.wall_density, (h, w))
        # the goal on an empty interior tile: every non-interior tile is a
        # border wall
        goal_tu = sampling.sample_empty_tile(k_goal, wall_map)
        wall_map = _without(wall_map, goal_tu)

        if cfg.ensure_reachable:
            iters = cfg.flood_iters if cfg.flood_iters > 0 else None
            valid = flood.flood_fill(~wall_map, goal_tu, iters)
        else:
            valid = ~wall_map
        valid = _without(valid, goal_tu)         # not on the goal
        sampled = sampling.sample_empty_tile(k_spawn, ~valid)
        # The goal is walled in: carve a spawn next to it (the interior is
        # at least 3x3, so the tile above or below is interior).
        gi = goal_tu[:, 0]
        fallback = torch.stack([torch.where(gi > 1, gi - 1, gi + 1), goal_tu[:, 1]], dim=-1)
        has_valid = valid.reshape(b, -1).any(dim=-1)
        spawn_tu = torch.where(has_valid[:, None], sampled, fallback)
        wall_map = _without(wall_map, spawn_tu)

        pos_wu, dir_au = self._spawn_pose(spawn_tu, k_dir)
        zeros_f = torch.zeros(b, dtype=torch.float32, device=dev)
        falses = torch.zeros(b, dtype=torch.bool, device=dev)
        return EnvState(
            wall_words=bitmap.pack_bits(wall_map),
            goal_tu=goal_tu,
            pos_wu=pos_wu,
            dir_au=dir_au,
            reward=zeros_f,
            done=falses,
            rng_key=next_key.contiguous(),
            t=torch.zeros(b, dtype=torch.int32, device=dev),
            episode_return=zeros_f.clone(),
            pending_reset=falses.clone(),
            hw=(h, w),
        )


def make(cfg: RandomRoomConfig | None = None, **kw) -> RandomRoom:
    return RandomRoom(cfg if cfg is not None else RandomRoomConfig(**kw))
