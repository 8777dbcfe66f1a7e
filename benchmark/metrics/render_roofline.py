"""The camera render's share of its roofline, in %: the least time the
H100 could take for the frames rendered in the traced stretch (the uint32
frame written once and the hits read once, against two compares per
pixel; ``roofline.render_work``) over the device time of the kernels
launched inside the span around ``ops/render.py``'s
``render_observation``."""

from benchmark import roofline

SPANS = {"ops.render_observation": "raycastworlds_tpu_torch.ops.render:render_observation"}


def read(trace, ctx):
    calls = len(trace.span_durations("ops.render_observation"))
    ops = trace.launched_within("ops.render_observation")
    busy_us = sum(o.dur for o in ops)
    if not calls or busy_us <= 0:
        return None
    env = ctx.config["env"]
    nbytes, flops = roofline.render_work(ctx.traffic["num_envs"], env["num_rays"],
                                         env["height_camera_view_pu"])
    return 100.0 * calls * roofline.bound_s(nbytes, flops) / (busy_us / 1e6)
