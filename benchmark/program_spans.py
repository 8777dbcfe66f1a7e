"""The program's own spans and counters, for the per-layer metrics that read
them.

The port records spans and counts at its layer boundaries
(``raycastworlds_tpu_torch.utils.profiling``: names ``rcw.*``) once its
tracer is on.  Importing this module turns it on.  The harness imports the
per-layer metrics only for a ``--trace 1`` run, after the measured window,
so the tracer records the traced stretches and nothing the end-to-end
metrics time.  The in-memory record is on ``time.perf_counter``'s clock,
the clock of the harness's host stretch (``ctx.host``); while the profiler
runs, each span is also a ``record_function`` range of the trace.

Where the program has no tracer (a version before it), ``recorded()`` is
None and the readers that use it return None.
"""

from __future__ import annotations

from typing import Optional, Tuple

try:
    from raycastworlds_tpu_torch.utils import profiling
except ImportError:
    profiling = None
if profiling is not None and hasattr(profiling, "enable"):
    profiling.enable()
else:
    profiling = None

# the root spans: one per step of the program (the adapter's holds the Env's)
ROOTS = ("rcw.env.step", "rcw.gym.step")


class Record:
    """The program's spans and counts as read."""

    def __init__(self, spans, counts):
        self.spans = spans
        self.counts = counts

    def inside(self, index: int, name: str) -> bool:
        """Whether span ``index`` is, or lies inside, a span named ``name``."""
        while index >= 0:
            if self.spans[index].name == name:
                return True
            index = self.spans[index].parent
        return False

    def in_window(self, index: int, window: Tuple[float, float]) -> bool:
        """Whether span ``index`` started inside ``window`` (us of
        ``perf_counter``)."""
        lo, hi = window
        return index >= 0 and lo <= self.spans[index].start_ns / 1e3 <= hi

    def span_ms(self, name: str, window: Tuple[float, float]) -> Optional[float]:
        """The ms inside spans named ``name`` that started in ``window``,
        each counted once where such spans nest, or None where there are
        none."""
        total, found = 0, False
        for i, s in enumerate(self.spans):
            if s.name != name or not s.end_ns or not self.in_window(i, window):
                continue
            if s.parent >= 0 and self.inside(s.parent, name):
                continue
            total += s.end_ns - s.start_ns
            found = True
        return total / 1e6 if found else None

    def counted(self, name: str, within: Optional[str] = None,
                window: Optional[Tuple[float, float]] = None) -> Optional[int]:
        """The counts of ``name`` recorded inside a span named ``within``
        (any span where None) that started in ``window`` (any time where
        None), summed, or None where there are none."""
        values = [c.value for c in self.counts if c.name == name
                  and (within is None or self.inside(c.span, within))
                  and (window is None or self.in_window(c.span, window))]
        return sum(values) if values else None


def recorded() -> Optional[Record]:
    """The program's record so far, or None where the program has no
    tracer or recorded nothing."""
    if profiling is None:
        return None
    rec = Record(profiling.spans(), profiling.counts())
    return rec if rec.spans else None


def per_host_step_ms(ctx, name: str) -> Optional[float]:
    """The host ms a step inside spans named ``name``, over the host
    stretch (no profiler running)."""
    rec = recorded()
    if rec is None or not ctx.host.steps:
        return None
    ms = rec.span_ms(name, ctx.host.window)
    return None if ms is None else ms / ctx.host.steps


def since_host_stretch(ctx) -> Tuple[float, float]:
    """From the start of the host stretch on: both traced stretches of
    this run, in us of ``perf_counter``."""
    return ctx.host.window[0], float("inf")
