"""The threefry hash's host time: per step of the host stretch (no
profiler running), the ms the program spent inside its
``rcw.rng.threefry`` spans (``rng.threefry2x32``: the dense reset's draws,
each a chain of elementwise launches), from the program's own record.
Silent where the program has no tracer."""

from benchmark import program_spans

SPANS = {}


def read(trace, ctx):
    return program_spans.per_host_step_ms(ctx, "rcw.rng.threefry")
