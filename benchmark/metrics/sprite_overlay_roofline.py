"""The sprite overlay's share of its roofline, in %: the least time the
H100 could take for the overlays of the profiled stretch (each uint32
pixel of every player's frame read once and written once, and each ray's
sprite and wall distances read once, ``sprite_overlay_work``) over the
device time of the kernels launched inside the program's
``rcw.ops.sprite_overlay`` spans (``ops/render.py``'s ``sprite_overlay``),
each call drawing over the batch's B * P frames.  Silent where the trace
holds no such span or no kernel launched in one."""

from benchmark import program_spans  # noqa: F401  (turns the program's tracer on)
from benchmark import roofline

SPANS = {}


def sprite_overlay_work(num_views: int, num_rays: int, hpu: int):
    """(bytes, operations) of one batched overlay of ``num_views`` uint32
    frames: 4 bytes read and 4 written a pixel, and 4 bytes of sprite
    distance and 4 of wall distance read a ray; the compares are not
    counted (the bytes bound it)."""
    return 8 * num_views * num_rays * hpu + 8 * num_views * num_rays, 0


def read(trace, ctx):
    calls = len(trace.span_durations("rcw.ops.sprite_overlay"))
    busy_us = sum(o.dur for o in trace.launched_within("rcw.ops.sprite_overlay"))
    if not calls or busy_us <= 0:
        return None
    env = ctx.config["env"]
    nbytes, ops = sprite_overlay_work(ctx.traffic["num_envs"] * env["num_players"],
                                      env["num_rays"], env["height_camera_view_pu"])
    return 100.0 * calls * roofline.bound_s(nbytes, ops) / (busy_us / 1e6)
