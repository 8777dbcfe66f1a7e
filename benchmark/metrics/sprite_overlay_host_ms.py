"""The sprite overlay's host time: per step of the host stretch (no
profiler running), the ms the program spent inside its
``rcw.ops.sprite_overlay`` spans (``ops/render.py``'s ``sprite_overlay``:
the billboard columns drawn over every player's camera frame), from the
program's own record.  Silent where the program has no tracer or no such
span."""

from benchmark import program_spans

SPANS = {}


def read(trace, ctx):
    return program_spans.per_host_step_ms(ctx, "rcw.ops.sprite_overlay")
