"""The yardstick of the roofline shares: the H100's peaks and the bytes and
operations each measured layer needs, counted from the cell's shapes.

A frozen copy of the port's on-chip smoke arithmetic (bytes read or written
once over the HBM rate against float operations over the float32 rate; four
operations per grid line a ray crosses, two compares per rendered pixel),
counted here from the shapes and poses of the cell rather than from a
wrapper's arguments, so a redesigned kernel is held to the same bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, and float32 operations/s outside
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Per grid line crossed: the crossing distance, the cross coordinate's
# multiply and add, and the compare.
OPS_PER_CROSSING = 4
# Per ray hit: the hit tile (2 x int32), the hit face (int32), the distance
# (float32).
HIT_BYTES = 16
# Per env pose: the position (2 x float32) and the heading (int32).
POSE_BYTES = 12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the chip could take: the larger of the bytes over the
    HBM rate and the operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def map_words(height: int, width: int) -> int:
    """32-bit words of a bit-packed height x width tile map."""
    return -(-height * width // 32)


def cast_work(num_envs: int, num_rays: int, height: int, width: int,
              crossings: int):
    """(bytes, operations) of one batched cast: each env's packed map and
    pose read once, each ray's hit written once; OPS_PER_CROSSING for each
    grid line the rays cross up to their hits (``crossings``, summed over
    the batch)."""
    nbytes = num_envs * (4 * map_words(height, width) + POSE_BYTES)
    nbytes += num_envs * num_rays * HIT_BYTES
    return nbytes, OPS_PER_CROSSING * crossings


def render_work(num_envs: int, num_rays: int, hpu: int):
    """(bytes, operations) of one batched camera render: the uint32 frames
    written once and the hits read once; two compares per pixel."""
    pixels = num_envs * num_rays * hpu
    return 4 * pixels + num_envs * num_rays * HIT_BYTES, 2 * pixels
