"""Debug-mode validation: NaN and out-of-map checks of env states.

The port of the JAX package's ``utils/debug.py``.  The JAX package wraps a
function with ``checkify``, which adds a guard to every operation inside
jit and collects NaN, out-of-bounds and division errors as a value.  Torch
has no checkify, and this module does not emulate its per-operation
guards: :func:`checked` checks the function's *outputs* after it returns,
explicitly (every floating tensor finite, every integer tile of a state
inside the map).  An out-of-range gather on a CUDA device is a device-side
assert that aborts the CUDA context; ``checked`` cannot turn it into an
error value.  :func:`validate_state` asserts, on the host, the invariants
the dynamics rely on (player inside the interior and off the walls, goal
on an empty interior tile, heading in range).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import EnvConfig
from ..state import EnvState
from . import to_numpy

# integer leaves holding (i, j) tiles; slots at (-1, -1) are empty
_TILE_LEAVES = ("goal_tu", "key_tu", "blocks", "goal_tiles")


class CheckError:
    """The failed checks of one call: ``get()`` gives their message or
    None, ``throw()`` raises a RuntimeError if any failed."""

    def __init__(self, messages: List[str]):
        self.messages = messages

    def get(self) -> Optional[str]:
        return "; ".join(self.messages) if self.messages else None

    def throw(self) -> None:
        if self.messages:
            raise RuntimeError(f"checked: {self.get()}")


def _tiles_outside(tiles: torch.Tensor, hw) -> torch.Tensor:
    i, j = tiles[..., 0], tiles[..., 1]
    empty = (i == -1) & (j == -1)
    inside = (i >= 0) & (i < hw[0]) & (j >= 0) & (j < hw[1])
    return ~(inside | empty)


def _check(out, path: str, messages: List[str]) -> None:
    if isinstance(out, EnvState):
        for k, v in out.leaves().items():
            _check(v, f"{path}.{k}", messages)
            if k in _TILE_LEAVES and out.hw is not None:
                n = int(_tiles_outside(v, out.hw).sum())
                if n:
                    messages.append(f"{path}.{k}: {n} tiles outside the {out.hw} map")
    elif torch.is_tensor(out):
        if out.is_floating_point():
            n = int((~torch.isfinite(out)).sum())
            if n:
                messages.append(f"{path}: {n} non-finite values")
    elif isinstance(out, dict):
        for k, v in out.items():
            _check(v, f"{path}[{k!r}]", messages)
    elif isinstance(out, tuple):
        names = getattr(out, "_fields", None) or range(len(out))
        for k, v in zip(names, out):
            _check(v, f"{path}.{k}" if isinstance(k, str) else f"{path}[{k}]", messages)


def checked(fn: Callable) -> Callable:
    """Wrap ``fn`` with explicit output checks.

    Returns ``wrapped(*args, **kwargs) -> (error, out)``; call
    ``error.throw()`` to raise on failure.  The checks walk ``out``
    (``EnvState`` leaves, ``StepResult``, tuples and dicts): every floating
    tensor must be finite, and every integer tile of a state (goal, key,
    block and goal-slot tiles) must lie inside its map.  Each check reads
    one count back to the host: keep it off the hot path.
    """

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        messages: List[str] = []
        _check(out, "out", messages)
        return CheckError(messages), out

    return wrapped


def _require(ok, msg: str) -> None:
    """An AssertionError, as the JAX package's asserts raise, that also
    holds under ``python -O``."""
    if not ok:
        raise AssertionError(msg)


def validate_state(cfg: EnvConfig, state: EnvState) -> None:
    """Host-side check of batched EnvState invariants (debug only); raises
    AssertionError naming the first that fails."""
    pos = to_numpy(state.pos_wu)
    goal = to_numpy(state.goal_tu)
    d = to_numpy(state.dir_au)
    walls = to_numpy(state.wall_map)
    _require(np.isfinite(pos).all(), "non-finite player position")
    _require((pos > 0).all(), "player outside the map (low)")
    _require((pos[..., 0] < cfg.H).all() and (pos[..., 1] < cfg.W).all(),
             "player outside the map (high)")
    _require(((d >= 0) & (d < cfg.num_directions)).all(), "heading out of range")
    _require((goal >= 1).all(), "goal on the border")
    _require((goal[..., 0] <= cfg.H - 2).all() and (goal[..., 1] <= cfg.W - 2).all(),
             "goal on the border")
    b_idx = np.arange(goal.shape[0])
    _require(not walls[b_idx, goal[:, 0], goal[:, 1]].any(), "goal inside a wall")
    # no player stands inside a wall tile (every player of an env)
    ti = np.floor(pos[..., 0]).astype(int)
    tj = np.floor(pos[..., 1]).astype(int)
    b_idx = b_idx.reshape((-1,) + (1,) * (ti.ndim - 1))
    _require(not walls[b_idx, ti, tj].any(), "player inside a wall tile")
