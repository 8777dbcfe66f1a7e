"""Environment state: a dataclass of batched tensors.

The leaves are the JAX package's ``EnvState`` leaves with the batch
dimension written out as the leading ``[B]`` axis:

  wall_words      int32[B, nw]  bit-packed walls (uint32 bit patterns)
  goal_tu         int32[B, 2]   goal tile
  pos_wu          float32[B, 2] player position
  dir_au          int32[B]      heading in [0, num_directions)
  reward          float32[B]
  done            bool[B]
  rng_key         int64[B, 2]   per-env threefry key (uint32 words, see rng)
  t               int32[B]      steps taken in the current episode
  episode_return  float32[B]
  pending_reset   bool[B]       always False under dense auto-reset

``hw`` is the static map size.  The engine has no model weights: the state
is what carries across steps, and ``from_numpy``/``to_numpy`` move it to and
from the JAX package's leaves (as numpy arrays) bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

LEAVES = (
    "wall_words", "goal_tu", "pos_wu", "dir_au", "reward", "done",
    "rng_key", "t", "episode_return", "pending_reset",
)


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

    @property
    def device(self) -> torch.device:
        return self.pos_wu.device

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)

    def leaves(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in LEAVES}

    def to(self, device) -> "EnvState":
        return self.replace(**{k: v.to(device) for k, v in self.leaves().items()})

    @classmethod
    def from_numpy(cls, leaves: Dict[str, np.ndarray], device=None) -> "EnvState":
        """Build a state from the JAX package's ``EnvState`` leaves given as
        numpy arrays (uint32 words and keys, int32, float32, bool)."""
        def conv(name, a):
            a = np.asarray(a)
            if name == "wall_words":
                a = a.astype(np.uint32).view(np.int32)
            elif name == "rng_key":
                a = a.astype(np.uint32).astype(np.int64)
            return torch.from_numpy(np.array(a)).to(device)

        missing = [k for k in LEAVES if k not in leaves]
        if missing:
            raise KeyError(f"missing state leaves: {missing}")
        hw = leaves.get("hw")
        return cls(
            **{k: conv(k, leaves[k]) for k in LEAVES},
            hw=tuple(hw) if hw is not None else None,
        )

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The inverse of :meth:`from_numpy`: the JAX package's leaf dtypes."""
        out = {}
        for k, v in self.leaves().items():
            a = v.detach().cpu().numpy()
            if k == "wall_words":
                a = a.view(np.uint32)
            elif k == "rng_key":
                a = a.astype(np.uint32)
            out[k] = a
        return out


def select(pred: torch.Tensor, on_true: EnvState, on_false: EnvState) -> EnvState:
    """Per-env select: ``pred`` bool[B]; every leaf has leading B."""
    def one(a, b):
        p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
        return torch.where(p, a, b)

    t, f = on_true.leaves(), on_false.leaves()
    return on_false.replace(**{k: one(t[k], f[k]) for k in LEAVES})

