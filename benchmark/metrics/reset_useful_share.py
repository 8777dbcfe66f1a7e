"""The share of the reset's rows that a step used, in %: 100 x the
episodes that ended (the program's ``episodes_ended``, the sum of each
step's ``done``) over the rows its resets computed (``reset_rows``: every
env for a dense reset), over both traced stretches, from the program's own
counters.  Silent where the program has no tracer."""

from benchmark import program_spans

SPANS = {}


def read(trace, ctx):
    rec = program_spans.recorded()
    if rec is None:
        return None
    window = program_spans.since_host_stretch(ctx)
    rows = rec.counted("reset_rows", window=window)
    if not rows:
        return None
    return 100.0 * (rec.counted("episodes_ended", window=window) or 0) / rows
