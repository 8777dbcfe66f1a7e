"""On-device random draws of the family resets, batched over keys.

Each function takes keys ``[B, 2]`` (see ``rng``) and draws for every key
exactly what the JAX package's unbatched function draws for that key alone.
A masked draw picks the k-th empty tile of a row-major prefix count with one
uniform: ``k = clip(floor(u * n), 0, max(n - 1, 0))`` over the ``n`` empty
tiles; an all-occupied map gives tile 0.
"""

from __future__ import annotations

import torch

from .. import rng


def _prefix_count(empty: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix count over the last axis of a 0/1 map, as float32.
    The JAX package builds it from blocked float32 matvecs; the counts are
    integers below 2**24, so an integer cumsum gives the same values."""
    return torch.cumsum(empty.to(torch.int32), dim=-1).to(torch.float32)


def _rank_draw(key: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """float32 rank ``clip(floor(u * n), 0, max(n - 1, 0))``: [B]."""
    u = rng.uniform(key, ())
    hi = torch.clamp(n - 1.0, min=0.0)
    return torch.minimum(torch.clamp(torch.floor(u * n), min=0.0), hi)


def _kth_empty(c: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Flat index i32[B] of the first tile whose prefix count exceeds ``k``
    (``argmax(c > k)``), or 0 when none does.  ``c`` is non-decreasing, so
    that tile's index is the number of counts ``<= k``."""
    idx = (c <= k[:, None]).sum(dim=-1, dtype=torch.int32)
    return torch.where(idx >= c.shape[-1], 0, idx)


def _tile(idx: torch.Tensor, w: int) -> torch.Tensor:
    return torch.stack([idx // w, idx % w], dim=-1)


def sample_empty_tile(key: torch.Tensor, occupied_map: torch.Tensor) -> torch.Tensor:
    """Uniform draw over the unoccupied tiles of bool[B, H, W]: i32[B, 2]."""
    b, _, w = occupied_map.shape
    c = _prefix_count(~occupied_map.reshape(b, -1))
    k = _rank_draw(key, c[:, -1])
    return _tile(_kth_empty(c, k), w)


def sample_empty_tile_pair(key_a, key_b, occupied_map: torch.Tensor):
    """An empty tile, then an empty tile other than the first, from one
    prefix count: the second rank is drawn over ``n - 1`` tiles and bumped
    past the first's rank (``k_a``).  Equal to two :func:`sample_empty_tile`
    draws, the second with the first tile occupied."""
    b, _, w = occupied_map.shape
    c = _prefix_count(~occupied_map.reshape(b, -1))
    n = c[:, -1]
    k1 = _rank_draw(key_a, n)
    k2 = _rank_draw(key_b, n - 1.0)
    k2 = k2 + (k1 <= k2).to(torch.float32)
    return _tile(_kth_empty(c, k1), w), _tile(_kth_empty(c, k2), w)


def sample_empty_interior_tile(
    key: torch.Tensor, h: int, w: int, exclude_ranks: torch.Tensor
) -> torch.Tensor:
    """Closed-form uniform draw over the interior of a border-walls-only map
    minus K excluded tiles: i32[B, 2].  ``exclude_ranks`` i32[B, K] holds
    the interior ranks (:func:`interior_rank`) of distinct tiles, K >= 0;
    the rank drawn over the complement is bumped past each excluded rank at
    or below it, in ascending order."""
    wi = w - 2
    kx = exclude_ranks.shape[-1]
    n = torch.tensor(float((h - 2) * wi - kx), dtype=torch.float32, device=key.device)
    r = _rank_draw(key, n).to(torch.int32)
    rs = torch.sort(exclude_ranks, dim=-1).values if kx > 1 else exclude_ranks
    for q in range(kx):
        r = r + (rs[:, q] <= r).to(torch.int32)
    return torch.stack([1 + r // wi, 1 + r % wi], dim=-1)


def sample_distinct_interior_tiles(keys: torch.Tensor, h: int, w: int, ranks=()):
    """K distinct interior tiles i32[B, K, 2], drawn in order by
    :func:`sample_empty_interior_tile`, tile k from ``keys[:, k]``, each
    excluding the tiles drawn before it and the interior ranks ``ranks`` (a
    sequence of i32[B]).  Returns the tiles and the list of ranks taken
    (``ranks``, then the new tiles')."""
    ranks = list(ranks)
    tiles = []
    for k in range(keys.shape[1]):
        ex = (torch.stack(ranks, dim=-1) if ranks
              else torch.zeros((keys.shape[0], 0), dtype=torch.int32, device=keys.device))
        tile = sample_empty_interior_tile(keys[:, k], h, w, ex)
        ranks.append(interior_rank(tile, w))
        tiles.append(tile)
    return torch.stack(tiles, dim=1), ranks


def interior_rank(tile: torch.Tensor, w: int) -> torch.Tensor:
    """Row-major interior rank ``(i-1)*(W-2) + (j-1)`` of interior tiles
    i32[..., 2]."""
    return (tile[..., 0] - 1) * (w - 2) + (tile[..., 1] - 1)


def sample_interior_tile(key: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Uniform tile in the interior ``[1, H-1) x [1, W-1)``: i32[B, 2]."""
    return rng.randint(key, (2,), [1, 1], [h - 1, w - 1])


def sample_heading(key: torch.Tensor, num_directions: int,
                   continuous: bool = False) -> torch.Tensor:
    """Uniform heading in ``[0, num_directions)`` per key: an int32 angle
    unit, or, for continuous headings, a float32 ``uniform`` with maxval
    ``num_directions``."""
    if continuous:
        return rng.uniform(key, (), maxval=float(num_directions))
    return rng.randint(key, (), 0, num_directions)
