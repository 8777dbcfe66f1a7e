"""Rollout drivers of the port."""
