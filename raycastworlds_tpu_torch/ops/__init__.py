"""Batched tensor ops of the port: bitmaps, collision, sampling, raycast, render."""

from . import units, collision, raycast, render, sampling  # noqa: F401
