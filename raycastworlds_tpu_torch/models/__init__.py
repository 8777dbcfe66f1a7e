"""World families of the port."""

from .base import Game  # noqa: F401
from .single_room import SingleRoom  # noqa: F401
from .random_room import RandomRoom, RandomRoomConfig  # noqa: F401
from .maze import Maze, MazeConfig  # noqa: F401
from .multi_goal import MultiGoalRoom, MultiGoalConfig  # noqa: F401
from .dynamic_room import DynamicRoom, DynamicRoomConfig  # noqa: F401
from .locked_room import LockedRoom, LockedRoomConfig  # noqa: F401
from .multi_player import MultiPlayerRoom, MultiPlayerConfig  # noqa: F401
