"""The auto-reset's host time: per step of the host stretch (no profiler
running), the ms the program spent inside its ``rcw.env.reset`` spans (the
dense reset of every env with its select, or the budgeted reset), from the
program's own record.  Silent where the program has no tracer."""

from benchmark import program_spans

SPANS = {}


def read(trace, ctx):
    return program_spans.per_host_step_ms(ctx, "rcw.env.reset")
