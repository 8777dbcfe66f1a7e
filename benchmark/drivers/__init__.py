"""Loop drivers, one module each, named by a traffic file's ``driver``.

A driver's ``Driver(program, config, traffic, seed, device)`` builds the
system under test through ``program`` (``sut.Port``), makes its inputs from
the seed, resets and warms up every shape it steps; then ``step()`` takes
one batched step and consumes its outputs, ``window(seconds)`` measures,
``sync()`` waits for the device, and ``outputs()`` hands what the check
compares.  ``objects`` names what spans may wrap.
"""

import numpy as np
import torch

LEAVES = ("goal_tu", "pos_wu", "dir_au", "rng_key", "t", "episode_return",
          "reward", "done")


def seed_words(seed: int) -> np.ndarray:
    """The env-reset key of a run: the seed's two 32-bit words (high, low)
    as a threefry key, uint32 [2]; any seed below 2**64."""
    seed = int(seed) % 2**64
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)


def host(x) -> np.ndarray:
    """A tensor as a host array (lower-precision floats as float32)."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.is_floating_point() and x.dtype not in (torch.float32, torch.float64):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def leaves(state) -> dict:
    """The state's leaves that the check compares, as host arrays."""
    return {name: host(getattr(state, name)) for name in LEAVES}
