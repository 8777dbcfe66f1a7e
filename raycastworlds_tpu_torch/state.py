"""Environment state: a dataclass of batched tensors.

The leaves are the JAX package's ``EnvState`` leaves with the batch
dimension written out as the leading ``[B]`` axis:

  wall_words      int32[B, nw]  bit-packed walls (uint32 bit patterns)
  goal_tu         int32[B, 2]   goal tile
  pos_wu          f[B, 2]       player position
  dir_au          int32[B]      heading in [0, num_directions); float32
                                under ``continuous_heading``
  reward          f[B]
  done            bool[B]
  rng_key         int64[B, 2]   per-env threefry key (uint32 words, see rng)
  t               int32[B]      steps taken in the current episode
  episode_return  f[B]
  pending_reset   bool[B]       episode ended, reset still owed (only under
                                ``Env(reset_budget=K)``)

``f`` is float32, or float64 under ``EnvConfig(dtype="float64")``: there
positions are float64 from the reset on, and reward and return become
float64 at the first step (a reset writes float32 zeros, as in the JAX
package).

MultiPlayerRoom adds a player axis to the pose and the rewards: ``pos_wu``
f[B, P, 2], ``dir_au`` [B, P], ``reward`` and ``episode_return``
float32[B, P] in every world (``done`` stays bool[B]); :func:`select`
broadcasts by rank.

And the optional leaves of the families that use them (None elsewhere):

  goal_words      int32[B, nw]  packed goal mask (MultiGoalRoom)
  goal_tiles      int32[B, K, 2] its goal tiles, collected ones at (-1, -1)
  blocks          int32[B, K, 3] moving blocks (i, j, dir) (DynamicRoom)
  key_tu          int32[B, 2]   key tile (LockedRoom)
  key_held        bool[B]       key collected: the doors are gone

A single-env state (``Game.*_single``) has the same leaves without the
leading ``[B]`` axis; :meth:`EnvState.batch1` and :meth:`EnvState.unbatch`
move between the two.

``hw`` is the static map size.  The engine has no model weights: the state
is what carries across steps, and ``from_numpy``/``to_numpy`` move it to and
from the JAX package's leaves (as numpy arrays) bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

LEAVES = (
    "wall_words", "goal_tu", "pos_wu", "dir_au", "reward", "done",
    "rng_key", "t", "episode_return", "pending_reset",
)
OPTIONAL_LEAVES = ("goal_words", "blocks", "goal_tiles", "key_tu", "key_held")
# Leaves holding packed words: int32 here, uint32 in the JAX package.
_WORD_LEAVES = ("wall_words", "goal_words")


@dataclasses.dataclass(frozen=True)
class EnvState:
    wall_words: torch.Tensor
    goal_tu: torch.Tensor
    pos_wu: torch.Tensor
    dir_au: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    rng_key: torch.Tensor
    t: torch.Tensor
    episode_return: torch.Tensor
    pending_reset: torch.Tensor
    hw: Tuple[int, int] = None
    goal_words: Optional[torch.Tensor] = None
    blocks: Optional[torch.Tensor] = None
    goal_tiles: Optional[torch.Tensor] = None
    key_tu: Optional[torch.Tensor] = None
    key_held: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.pos_wu.device

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.dir_au.shape)

    @property
    def wall_map(self) -> torch.Tensor:
        """Dense bool[B, H, W] wall map, unpacked on demand (debug, top
        view and tile-grid consumers; never on the step's hot path)."""
        from .ops import bitmap

        return bitmap.unpack_bits(self.wall_words, self.hw)

    def replace_walls(self, wall_map: torch.Tensor) -> "EnvState":
        """A state with a new dense wall map (re-packed)."""
        from .ops import bitmap

        return self.replace(wall_words=bitmap.pack_bits(wall_map))

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Every leaf that is not None, required leaves first."""
        out = {k: getattr(self, k) for k in LEAVES}
        for k in OPTIONAL_LEAVES:
            if getattr(self, k) is not None:
                out[k] = getattr(self, k)
        return out

    def to(self, device) -> "EnvState":
        return self.replace(**{k: v.to(device) for k, v in self.leaves().items()})

    def index(self, idx: torch.Tensor) -> "EnvState":
        """The envs ``idx`` (int[K]) of every leaf: a state of K envs."""
        return self.replace(**{k: v[idx] for k, v in self.leaves().items()})

    def batch1(self) -> "EnvState":
        """A single-env state (the JAX package's unbatched leaves: ``pos_wu``
        f[2], ``dir_au`` [], ``rng_key`` int64[2], ...) as a batch of one
        env: every leaf gains a leading axis of size 1."""
        return self.replace(**{k: v[None] for k, v in self.leaves().items()})

    def unbatch(self) -> "EnvState":
        """The inverse of :meth:`batch1`: env 0 of every leaf, without the
        env axis."""
        return self.replace(**{k: v[0] for k, v in self.leaves().items()})

    @classmethod
    def from_numpy(cls, leaves: Dict[str, np.ndarray], device=None) -> "EnvState":
        """Build a state from the JAX package's ``EnvState`` leaves given as
        numpy arrays (uint32 words and keys, int32, float32 or float64,
        bool); float leaves keep their dtype.  Optional leaves that are
        absent or None stay None."""
        def conv(name, a):
            a = np.asarray(a)
            if name in _WORD_LEAVES:
                a = a.astype(np.uint32).view(np.int32)
            elif name == "rng_key":
                a = a.astype(np.uint32).astype(np.int64)
            return torch.from_numpy(np.array(a)).to(device)

        missing = [k for k in LEAVES if k not in leaves]
        if missing:
            raise KeyError(f"missing state leaves: {missing}")
        hw = leaves.get("hw")
        present = LEAVES + tuple(
            k for k in OPTIONAL_LEAVES if leaves.get(k) is not None
        )
        return cls(
            **{k: conv(k, leaves[k]) for k in present},
            hw=tuple(hw) if hw is not None else None,
        )

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The inverse of :meth:`from_numpy`: the JAX package's leaf dtypes,
        for every leaf that is not None."""
        out = {}
        for k, v in self.leaves().items():
            a = v.detach().cpu().numpy()
            if k in _WORD_LEAVES:
                a = a.view(np.uint32)
            elif k == "rng_key":
                a = a.astype(np.uint32)
            out[k] = a
        return out


def select(pred: torch.Tensor, on_true: EnvState, on_false: EnvState) -> EnvState:
    """Per-env select: ``pred`` bool[B]; every leaf has leading B, and both
    states carry the same optional leaves."""
    def one(a, b):
        p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
        return torch.where(p, a, b)

    t, f = on_true.leaves(), on_false.leaves()
    if t.keys() != f.keys():
        raise ValueError(f"states carry different leaves: {sorted(t)} vs {sorted(f)}")
    return on_false.replace(**{k: one(t[k], f[k]) for k in f})


def default_device(device, what: str) -> torch.device:
    """``device``, or the CUDA device where it is None, raising where there
    is none: the CPU is only ever asked for, never fallen back to.
    ``what`` names the caller in the error."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on the CUDA device by default and none is "
                'available; pass device="cpu" to run on the CPU'
            )
        device = "cuda"
    return torch.device(device)


def tile_map(state: EnvState) -> torch.Tensor:
    """The reference's tile map, bool[B, 2, H, W] (wall and goal channels)."""
    from .ops import bitmap

    h, w = state.hw
    if state.goal_words is not None:
        goal_map = bitmap.unpack_bits(state.goal_words, (h, w))
    else:
        ii = torch.arange(h, device=state.device)[:, None]
        jj = torch.arange(w, device=state.device)[None, :]
        gi, gj = state.goal_tu[..., 0], state.goal_tu[..., 1]
        goal_map = (ii == gi[..., None, None]) & (jj == gj[..., None, None])
    return torch.stack([state.wall_map, goal_map], dim=-3)


def metrics(state: EnvState) -> Dict[str, torch.Tensor]:
    return {
        "reward": state.reward,
        "done": state.done,
        "t": state.t,
        "episode_return": state.episode_return,
    }
