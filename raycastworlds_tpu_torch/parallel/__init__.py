"""Rollout drivers, the PPO trainers and the (dp, mp) mesh of the port."""
