"""The part of the device's idle time that the program leaves, in %: 100 x
the idle time of the profiled stretch during which the host was inside one
of the program's root spans (``rcw.env.step``, ``rcw.gym.step``: the
program's own step, as against the harness's or the consumer's code
between steps) over all its idle time, by interval intersection on the
trace's clock.  Silent where the trace holds no such span or no device
event."""

from benchmark import program_spans, profile_trace

SPANS = {}


def read(trace, ctx):
    inside = profile_trace.merged(r for name in program_spans.ROOTS
                                  for r in trace.spans.get(name, []))
    if not inside or not trace.device_ops:
        return None
    gaps = trace.idle_gaps()
    idle = sum(length for _, length in gaps)
    covered = sum(max(0.0, min(start + length, e) - max(start, s))
                  for start, length in gaps for s, e in inside)
    return 100.0 * covered / idle if idle > 0 else None
