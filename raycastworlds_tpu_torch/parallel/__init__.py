"""Rollout drivers, the PPO trainers and the (dp, mp) mesh of the port."""

from . import mesh  # noqa: F401
from .rollout import Trajectory, rollout_random, rollout_policy, steps_per_second_program  # noqa: F401
from .ppo import PPOConfig, PPOTrainer, ActorCritic  # noqa: F401
