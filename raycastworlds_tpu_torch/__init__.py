"""raycastworlds_tpu_torch -- the raycast world engine in PyTorch and CUDA.

The port of ``raycastworlds_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100.  The JAX package is the reference: module names match, and the tests
hold each module of this package against its JAX counterpart.  This package
imports ``torch`` and numpy only.

* ``EnvConfig`` -- static config, field for field the JAX package's
* ``EnvState``  -- dataclass of batched ``[B, ...]`` tensors
* ``SingleRoom`` -- the walled room with one goal
* ``RandomRoom``, ``Maze``, ``MultiGoalRoom``, ``DynamicRoom``,
  ``LockedRoom``, ``MultiPlayerRoom`` -- the other world families, each
  with its config class
* ``Env``       -- batched auto-resetting environment on one device
* ``GymAdapter``, ``GymVectorAdapter`` -- gymnasium-style single-env and
  vector-env facades (numpy out)
* ``FrameStack``, ``ObsTransform`` -- composable env wrappers
* ``rng``       -- threefry-2x32, bit-exact with ``jax.random`` (a CUDA kernel on the card)
* ``ops``       -- raycasts (plain and CUDA kernels), collision, render,
  top view
* ``utils``     -- checkpoints, debug checks, profiling, episode video,
  the terminal/X11 and browser viewers
* ``examples``  -- the demo and profile scripts (``python -m``)
"""

from .config import (
    ACTION_NAMES,
    MOVE_BACKWARD,
    MOVE_FORWARD,
    NUM_ACTIONS,
    TURN_LEFT,
    TURN_RIGHT,
    EnvConfig,
)
from .env import Env, Space, StepResult
from .models.dynamic_room import DynamicRoom, DynamicRoomConfig
from .models.locked_room import LockedRoom, LockedRoomConfig
from .models.maze import Maze, MazeConfig
from .models.multi_goal import MultiGoalConfig, MultiGoalRoom
from .models.multi_player import MultiPlayerConfig, MultiPlayerRoom
from .models.random_room import RandomRoom, RandomRoomConfig
from .models.single_room import SingleRoom
from .state import EnvState, tile_map
from .gym_compat import GymAdapter, GymVectorAdapter
from .wrappers import FrameStack, ObsTransform
from . import colors, rng

__version__ = "0.1.0"

__all__ = [
    "EnvConfig",
    "EnvState",
    "Env",
    "Space",
    "StepResult",
    "SingleRoom",
    "RandomRoom",
    "RandomRoomConfig",
    "Maze",
    "MazeConfig",
    "MultiGoalRoom",
    "MultiGoalConfig",
    "DynamicRoom",
    "DynamicRoomConfig",
    "LockedRoom",
    "LockedRoomConfig",
    "MultiPlayerRoom",
    "MultiPlayerConfig",
    "GymAdapter",
    "GymVectorAdapter",
    "FrameStack",
    "ObsTransform",
    "tile_map",
    "colors",
    "rng",
    "NUM_ACTIONS",
    "MOVE_FORWARD",
    "MOVE_BACKWARD",
    "TURN_LEFT",
    "TURN_RIGHT",
    "ACTION_NAMES",
]
