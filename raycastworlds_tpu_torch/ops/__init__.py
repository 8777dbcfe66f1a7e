"""Batched tensor ops of the port: bitmaps, collision, sampling, raycast, render."""
