"""Tools of the port: checkpoints, debug checks, profiling, episode video,
the frame viewers, and the host copy they share."""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """One host copy of a tensor as a numpy array (a ``torch.uint32`` tensor
    through its int32 view: the same bits, and no uint32 kernel on the
    device); numpy arrays and scalars pass through ``np.asarray``."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.detach()
    if x.dtype == torch.uint32:
        return x.view(torch.int32).cpu().numpy().view(np.uint32)
    return x.cpu().numpy()


# The tools read to_numpy from this package, so they come after it.
from . import checkpoint, debug, profiling, viewer  # noqa: E402, F401
