"""Tools of the port: checkpoints, debug checks, profiling, episode video,
the frame viewers, and the host copy they share."""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """One host copy of a tensor as a numpy array (a ``torch.uint32`` tensor
    through its int32 view: the same bits, and no uint32 kernel on the
    device); numpy arrays and scalars pass through ``np.asarray``.  A
    tensor's bytes go to the ``host_copy_bytes`` counter, read from its
    size (no sync)."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.detach()
    profiling.count("host_copy_bytes", x.numel() * x.element_size())
    if x.dtype == torch.uint32:
        return x.view(torch.int32).cpu().numpy().view(np.uint32)
    return x.cpu().numpy()


# The tools read to_numpy from this package, so they come after it.
# ``checkpoint`` imports the trainers, which import ``env``, which imports
# ``profiling`` from here: it is imported on first use.
from . import debug, profiling, viewer  # noqa: E402, F401


def __getattr__(name: str):
    if name == "checkpoint":
        import importlib

        return importlib.import_module(f"{__name__}.checkpoint")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
