"""Checkpoint / resume of env and training state, as one numpy ``.npz``.

The port of ``raycastworlds_tpu.utils.checkpoint``'s npz path (no Orbax, no
pickle of modules or objects).  A state is a tree of ``EnvState``s,
NamedTuples (``TrainState``, ``RnnTrainState``), dicts, tensors and Python
numbers; each leaf is stored under its path (``params/trunk.weight``,
``env_state/pos_wu``, ``opt_state/mu/trunk.weight``, ``key``, ``hidden``,
``update_count``), the env state as its ``to_numpy()`` leaves (the JAX
package's dtypes).  The env's per-env threefry keys and the trainer's key
are part of the state, so a restored trainer continues exactly as an
uninterrupted one.

Under a mesh (``parallel/mesh.py``) ``save(..., mesh=)`` gathers every
rank's rows and mp shards and rank 0 writes one file with the leaves and
values of a one-process save; ``restore(..., mesh=)`` gives each rank its
rows and shards of such a file, whichever topology wrote it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..parallel import mesh as mesh_lib
from ..parallel.ppo import gather_train_state, shard_train_state
from ..state import EnvState


def _flatten(tree: Any, path: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, EnvState):
        for k, v in tree.to_numpy().items():
            out[path + k] = v
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            _flatten(getattr(tree, k), path + k + "/", out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, path + k + "/", out)
    elif torch.is_tensor(tree):
        out[path[:-1]] = tree.detach().cpu().numpy()
    elif isinstance(tree, (int, float)):
        out[path[:-1]] = np.asarray(tree)
    else:
        raise TypeError(f"cannot checkpoint {type(tree).__name__} at {path!r}")


def _is_train_state(tree: Any) -> bool:
    return isinstance(tree, tuple) and {"params", "env_state"} <= set(getattr(tree, "_fields", ()))


def _gather(tree: Any, mesh: mesh_lib.Mesh) -> Any:
    """The global tree of a rank's env state or trainer state (a
    collective); other trees are held whole by every rank already."""
    if isinstance(tree, EnvState):
        return mesh_lib.gather_env_state(tree, mesh)
    return gather_train_state(tree, mesh) if _is_train_state(tree) else tree


def _shard(tree: Any, mesh: mesh_lib.Mesh) -> Any:
    if isinstance(tree, EnvState):
        return mesh_lib.shard_env_state(tree, mesh)
    return shard_train_state(tree, mesh) if _is_train_state(tree) else tree


def save(path: str, train_state: Any, metadata: Optional[dict] = None,
         mesh: Optional[mesh_lib.Mesh] = None) -> str:
    """Save ``train_state`` (a trainer state, or any tree of the kinds
    above) to ``path`` (``.npz`` appended if missing), with ``metadata`` as
    JSON under ``__meta__``.  Returns the path written.  Under ``mesh``
    every rank calls it with its piece; rank 0 writes the global state, and
    every rank returns once the file is there."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    if mesh is not None:
        train_state = _gather(train_state, mesh)
        if mesh.rank != 0:
            mesh.barrier()
            return path
    arrays: Dict[str, np.ndarray] = {}
    _flatten(train_state, "", arrays)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __meta__=json.dumps(metadata or {}), **arrays)
    if mesh is not None:
        mesh.barrier()
    return path


def _unflatten(target: Any, path: str, data) -> Any:
    if isinstance(target, EnvState):
        names = target.to_numpy().keys()
        leaves = {k: data[path + k] for k in names}
        return EnvState.from_numpy(leaves, device=target.device).replace(hw=target.hw)
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(_unflatten(getattr(target, k), path + k + "/", data)
                               for k in target._fields))
    if isinstance(target, dict):
        return {k: _unflatten(v, path + k + "/", data) for k, v in target.items()}
    arr = data[path[:-1]]
    if torch.is_tensor(target):
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{path[:-1]}: checkpoint shape {arr.shape}, target "
                             f"{tuple(target.shape)}")
        return torch.from_numpy(arr).to(device=target.device, dtype=target.dtype)
    return type(target)(arr)


def restore(path: str, target: Any, mesh: Optional[mesh_lib.Mesh] = None) -> Any:
    """Restore a checkpoint into the structure of ``target`` (e.g. a freshly
    initialized trainer state): tensors on the target's devices and in its
    dtypes.  Raises if the checkpoint holds other leaves or shapes.  Under
    ``mesh`` every rank calls it with its own piece as ``target`` and gets
    its rows and shards of the global state in the file."""
    if mesh is not None:
        return _shard(restore(path, _gather(target, mesh)), mesh)
    if not path.endswith(".npz"):
        path = path + ".npz"
    want: Dict[str, np.ndarray] = {}
    _flatten(target, "", want)
    with np.load(path, allow_pickle=False) as data:
        have = set(data.files) - {"__meta__"}
        if have != set(want):
            raise ValueError(f"checkpoint leaves differ from the target's: only in the "
                             f"checkpoint {sorted(have - set(want))}, only in the target "
                             f"{sorted(set(want) - have)}")
        return _unflatten(target, "", {k: data[k] for k in have})
