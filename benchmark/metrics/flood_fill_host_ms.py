"""The reachability fill's host time: per step of the host stretch (no
profiler running), the ms the program spent inside its
``rcw.ops.flood_fill`` spans (``ops/flood.py``'s ``flood_fill``: each
reset's iterated dilations), from the program's own record.  Silent where
the program has no tracer or no such span."""

from benchmark import program_spans

SPANS = {}


def read(trace, ctx):
    return program_spans.per_host_step_ms(ctx, "rcw.ops.flood_fill")
