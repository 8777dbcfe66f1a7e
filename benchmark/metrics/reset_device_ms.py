"""The reset's device time: the kernels launched inside the span around
each ``Game.reset_batch`` call (the dense reset of every env and its
threefry draws), summed over the traced stretch, per step, in ms."""

SPANS = {"models.reset_batch": "game.reset_batch"}


def read(trace, ctx):
    ops = trace.launched_within("models.reset_batch")
    if not ops or not trace.steps:
        return None
    return sum(o.dur for o in ops) / trace.steps / 1e3
