"""Carrying weights and optimizer state between the JAX package and the port.

The JAX trainers hold flax ``{"params": ...}`` trees and optax states; the
port holds ``{name: tensor}`` dictionaries keyed like the modules'
``state_dict``.  These functions take the JAX side as numpy arrays (e.g.
``jax.tree_util.tree_map(np.asarray, ts.params)``), so that the port never
imports JAX.  The layouts differ:

* Dense kernel ``[in, out]`` -> ``weight [out, in]`` (transposed);
* Conv kernel HWIO -> ``weight`` OIHW;
* flax flattens the conv output NHWC; the port permutes its activations to
  NHWC before the flatten (``ImageTrunk``), so the trunk's kernel only
  transposes.

flax's automatic names become the port's: ``Conv_0``/``Conv_1`` ->
``features.conv0``/``features.conv1``, ``patch`` -> ``features.patch``;
``trunk``, ``trunk2``, ``embed``, ``policy``, ``value`` and ``gru/{ir, iz,
in, hr, hz, hn}`` keep theirs.

With a ``mesh`` the feedforward params and moments land as this rank's mp
shards on the mesh's device (``ppo.shard_params``), so that the same JAX
params give the same computation on any mesh; the recurrent trainer's are
replicated and carried whole.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .mesh import Mesh
from .ppo import shard_params

_RENAME = {"Conv_0": "features.conv0", "Conv_1": "features.conv1",
           "patch": "features.patch"}


def _weight(kernel: np.ndarray) -> np.ndarray:
    if kernel.ndim == 4:  # HWIO -> OIHW
        return kernel.transpose(3, 2, 0, 1)
    return kernel.T


def _convert(tree: Dict[str, Any], prefix: str, out: Dict[str, np.ndarray]) -> None:
    for name, sub in tree.items():
        path = prefix + (name if prefix else _RENAME.get(name, name))
        if "kernel" in sub:
            out[path + ".weight"] = _weight(np.asarray(sub["kernel"]))
            if "bias" in sub:
                out[path + ".bias"] = np.asarray(sub["bias"])
        else:
            _convert(sub, path + ".", out)


def _params_from_flax(params_np: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    out: Dict[str, np.ndarray] = {}
    _convert(params_np["params"], "", out)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in out.items()}


def actor_critic_from_flax(params_np: Dict[str, Any], device=None,
                           mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """The port's params of a flax ``ActorCritic`` tree (``{"params":
    {...}}`` of numpy arrays), float32: whole on ``device``, or this rank's
    mp shards on the mesh's device under ``mesh``."""
    params = _params_from_flax(params_np, device)
    return params if mesh is None else shard_params(params, mesh)


def recurrent_from_flax(params_np: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """The port's params of a flax ``RecurrentActorCritic`` tree, whole and
    float32 on ``device`` (the GRU layers nest under "gru")."""
    return _params_from_flax(params_np, device)


def adam_from_optax(opt_state_np, device=None, mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """The port's optimizer state (``{"count", "mu", "nu"}``) from the JAX
    trainers' ``optax.chain(clip_by_global_norm, adam)`` state as numpy
    leaves: the ``ScaleByAdamState`` found in the chain, its moments laid
    out as the params (as ``actor_critic_from_flax`` lays them under
    ``mesh``; pass none for the recurrent trainer's)."""
    stack = [opt_state_np]
    while stack:
        node = stack.pop()
        if hasattr(node, "mu") and hasattr(node, "nu"):
            return {
                "count": int(np.asarray(node.count)),
                "mu": actor_critic_from_flax(node.mu, device, mesh),
                "nu": actor_critic_from_flax(node.nu, device, mesh),
            }
        if isinstance(node, (tuple, list)):
            stack.extend(node)
    raise ValueError("no adam state (mu, nu, count) in the optimizer state")
