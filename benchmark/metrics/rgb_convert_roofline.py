"""The RGB conversion's share of its roofline, in %: the least time the
H100 could take for the conversions of the profiled stretch (each uint32
pixel read once and its three bytes written once, ``rgb_convert_work``)
over the device time of the kernels launched inside the program's
``rcw.ops.u32_to_rgb`` spans (``ops/render.py``'s ``u32_to_rgb``), each
call converting the batch's frames.  Silent where the trace holds no such
span or no kernel launched in one."""

from benchmark import program_spans  # noqa: F401  (turns the program's tracer on)
from benchmark import roofline

SPANS = {}


def rgb_convert_work(num_envs: int, num_rays: int, hpu: int):
    """(bytes, operations) of one batched conversion of uint32 frames to
    uint8 RGB: 4 bytes read and 3 written a pixel; the shifts and masks are
    not counted (the bytes bound it)."""
    return 7 * num_envs * num_rays * hpu, 0


def read(trace, ctx):
    calls = len(trace.span_durations("rcw.ops.u32_to_rgb"))
    busy_us = sum(o.dur for o in trace.launched_within("rcw.ops.u32_to_rgb"))
    if not calls or busy_us <= 0:
        return None
    env = ctx.config["env"]
    nbytes, ops = rgb_convert_work(ctx.traffic["num_envs"], env["num_rays"],
                                   env["height_camera_view_pu"])
    return 100.0 * calls * roofline.bound_s(nbytes, ops) / (busy_us / 1e6)
