"""Reading a torch.profiler Chrome trace of the traced stretch.

The trace holds the harness's step spans (``STEP_LABEL``), the spans it
wrapped around program calls (``user_annotation`` events), the CUDA runtime
calls that launched work and the device's kernels and copies.  A device
event belongs to a span when the runtime call that launched it lies inside
the span, matched through the trace's correlation ids, as the port's
``utils/profiling.aggregate_trace`` does (a frozen copy of that matching).
The profiler can drop records from a window; every sum is of what it kept.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Optional, Tuple

STEP_LABEL = "bench.step"
PROFILER_STEP = "ProfilerStep#"   # the profiler's own step annotations
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class DeviceOp(NamedTuple):
    name: str
    cat: str
    ts: float       # us
    dur: float      # us
    launch: Optional[float]   # host ts of the launching runtime call, us


def merged(ranges) -> List[List[float]]:
    """Sorted disjoint unions of (start, end) ranges."""
    out: List[List[float]] = []
    for start, end in sorted(ranges):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _inside(ranges: List[List[float]], starts: List[float], ts: Optional[float]) -> bool:
    if ts is None:
        return False
    k = bisect.bisect_right(starts, ts) - 1
    return k >= 0 and ts <= ranges[k][1]


class Trace:
    """The traced stretch: ``steps`` whole steps, from the first step span's
    start to the later of the last step span's end and the end of the last
    device event launched within them."""

    def __init__(self, events: List[dict]):
        xs = [e for e in events if e.get("ph") == "X"]
        steps = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in xs
                       if e.get("cat") == "user_annotation" and e.get("name") == STEP_LABEL)
        self.steps = len(steps)
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        for e in xs:
            if (e.get("cat") == "user_annotation" and e.get("name") != STEP_LABEL
                    and not str(e.get("name")).startswith(PROFILER_STEP)):
                self.spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e.get("dur", 0)))
        for v in self.spans.values():
            v.sort()
        self.cpu_ops = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in xs
                              if e.get("cat") == "cpu_op")
        launch = {}
        for e in xs:
            if e.get("cat") in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch[corr] = e["ts"]
        if not steps:
            self.window = (0.0, 0.0)
            self.device_ops: List[DeviceOp] = []
            return
        start, host_end = steps[0][0], steps[-1][1]
        ops = []
        for e in xs:
            if str(e.get("cat", "")).lower() not in DEVICE_CATS:
                continue
            at = launch.get((e.get("args") or {}).get("correlation"))
            when = at if at is not None else e["ts"]
            if start <= when <= host_end:
                ops.append(DeviceOp(e["name"], str(e["cat"]).lower(), e["ts"],
                                    e.get("dur", 0), at))
        ops.sort(key=lambda o: o.ts)
        self.device_ops = ops
        end = max([host_end] + [o.ts + o.dur for o in ops])
        self.window = (start, end)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def kernels(self) -> List[DeviceOp]:
        return [o for o in self.device_ops if o.cat == "kernel"]

    def span_durations(self, label: str) -> List[float]:
        """Durations (us) of the spans so labelled, in order."""
        return [end - start for start, end in self.spans.get(label, [])]

    def spans_within(self, inner: str, outer: str) -> List[float]:
        """Per span labelled ``outer``: the us that spans labelled ``inner``
        cover inside it."""
        inner_ranges = merged(self.spans.get(inner, []))
        out = []
        for start, end in self.spans.get(outer, []):
            out.append(sum(max(0.0, min(end, e) - max(start, s)) for s, e in inner_ranges))
        return out

    def launched_within(self, label: str, ops: Optional[List[DeviceOp]] = None) -> List[DeviceOp]:
        """The device events (kernels by default) launched inside a span
        labelled ``label``."""
        ranges = merged(self.spans.get(label, []))
        starts = [r[0] for r in ranges]
        pool = self.kernels if ops is None else ops
        return [o for o in pool if _inside(ranges, starts, o.launch)]

    def busy_intervals(self) -> List[List[float]]:
        """The union of the device events' intervals, clipped to the window."""
        lo, hi = self.window
        return merged((max(lo, o.ts), min(hi, o.ts + o.dur)) for o in self.device_ops
                      if o.ts + o.dur > lo and o.ts < hi)

    def busy_us(self) -> float:
        return sum(end - start for start, end in self.busy_intervals())

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """(start, length) of each stretch of the window with no device
        event running, in us."""
        lo, hi = self.window
        gaps, at = [], lo
        for start, end in self.busy_intervals():
            if start > at:
                gaps.append((at, start - at))
            at = max(at, end)
        if hi > at:
            gaps.append((at, hi - at))
        return gaps

    def host_at(self, ts: float) -> str:
        """What the host was doing at ``ts``: the innermost wrapped span and
        the innermost CPU operator open then."""
        span = None
        for label, ranges in self.spans.items():
            for start, end in ranges:
                if start <= ts <= end and (span is None or start >= span[0]):
                    span = (start, label)
        op = None
        k = bisect.bisect_right(self.cpu_ops, (ts, float("inf"), ""))
        for start, end, name in reversed(self.cpu_ops[max(0, k - 64):k]):
            if start <= ts <= end:
                op = name
                break
        parts = [span[1] if span else "harness"] + ([op] if op else [])
        return " / ".join(parts)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took the most time, and the longest
        idle gaps by what the host was doing, in seconds."""
        by_name: Dict[str, float] = {}
        for o in self.device_ops:
            by_name[o.name] = by_name.get(o.name, 0.0) + o.dur
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: -g[1])[:top]
        return {
            "device_ops": [[name[:200], us / 1e6] for name, us in ops],
            "idle_gaps": [[self.host_at(start + length / 2)[:200], length / 1e6]
                          for start, length in gaps],
        }
