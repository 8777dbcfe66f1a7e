"""Profiling, tracing and metrics helpers.

The port of the JAX package's ``utils/profiling.py``, with the port's own
tracer:

* :func:`span` -- a named span (context manager or decorator) at one of the
  port's layer boundaries; :func:`count` and :func:`count_device` --
  counters at the same boundaries; :func:`enable` / :func:`disable` /
  :func:`clear` switch and empty the tracer, :func:`spans` / :func:`counts`
  / :func:`total` read it;
* :func:`trace` -- context manager around ``torch.profiler`` (CPU and, where
  there is one, CUDA activity) writing a Chrome trace into a directory,
  with the tracer on, so the port's spans sit beside the device's kernels;
* :func:`annotate` -- the decorator form of :func:`span`;
* :func:`aggregate_trace` -- a trace's device time, summed by kernel name,
  and the part of it launched inside each annotated range;
* :class:`Meter` -- host-side steps/s and episode statistics, fed once per
  log interval;
* :func:`device_metrics` -- a [T, B] rollout reduced to scalar metrics on
  its device.

The tracer is off by default.  Off, a span costs one check of a
module-level flag on entry (and one of an empty list on exit): no clock
read, no allocation, no ``record_function``.  On, each span records its
name, start and end (``time.perf_counter_ns``), the index of its parent
span and a step id shared by every span under one root span (one
``Env.step`` or adapter step), and, while a ``torch.profiler`` is running,
opens a ``record_function`` of the same name, so the profiler's trace holds
the span on the device trace's own clock.  :func:`trace_us` converts a
recorded time to a Chrome trace's microseconds through the clock anchor
taken at :func:`enable` and the trace's ``baseTimeNanoseconds``.  The
record is bounded (:func:`dropped` counts what it left out) and kept for
the thread that turned the tracer on.

Counters: ``count(name, n)`` adds ``n`` to a process-wide total whether the
tracer is on or off, and while it is on also records ``n`` against the
innermost open span, so a reader can sum a counter over the spans of one
stretch.  ``count_device(name, tensor)`` keeps a reference to a tensor the
step computed anyway while the tracer is on (nothing while it is off), and
:func:`counts` reduces it by a sum only when read: tracing adds no kernel
and no host sync to a step.  The port's spans and counters are named in
``PERF.md`` (section 3).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import torch

TRACE_FILE = "trace.json"


# -- the tracer ---------------------------------------------------------

CAPACITY = 1 << 16       # spans, and separately counts, kept at most
DEVICE_CAPACITY = 4096   # tensors kept by count_device at most

_on = False          # the switch every span and counter checks first
_owner = None        # the thread that turned the tracer on
_anchor_ns = 0       # time.time_ns() - time.perf_counter_ns() at enable()
_spans: List[list] = []    # [name, start_ns, end_ns, parent, step] per span
_counts: List[tuple] = []  # (span index, name, int or tensor) per count
_stack: List[tuple] = []   # open spans: (span, index, step, record_function)
_totals: Dict[str, int] = {}
_kept_tensors = 0
_dropped = 0
_next_step = 0


class SpanRecord(NamedTuple):
    name: str
    start_ns: int   # time.perf_counter_ns()
    end_ns: int     # 0 while the span is open
    parent: int     # index of the enclosing span in spans(), -1 for a root
    step: int       # shared by every span under one root span


class CountRecord(NamedTuple):
    span: int       # index of the innermost span open at the count, or -1
    name: str
    value: int


class _Span:
    """A named span: ``with span(name):`` or ``@span(name)``."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _on:
            _open(self)
        return self

    def __exit__(self, *exc) -> bool:
        if _stack and _stack[-1][0] is self and threading.get_ident() == _owner:
            _close()
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with self:
                return fn(*args, **kwargs)

        return wrapped


_named: Dict[str, _Span] = {}


def span(name: str) -> _Span:
    """The span named ``name`` (one object per name, so the off path
    allocates nothing): a context manager, and a decorator of functions."""
    s = _named.get(name)
    if s is None:
        s = _named[name] = _Span(name)
    return s


def _open(s: _Span) -> None:
    global _dropped, _next_step
    if threading.get_ident() != _owner:
        return
    if _stack:
        parent, step = _stack[-1][1], _stack[-1][2]
    else:
        parent, step = -1, _next_step
        _next_step += 1
    rf = None
    if torch._C._autograd._profiler_enabled():
        rf = torch.profiler.record_function(s.name)
        rf.__enter__()
    index = len(_spans)
    if index < CAPACITY:
        _spans.append([s.name, time.perf_counter_ns(), 0, parent, step])
    else:
        index = -1
        _dropped += 1
    _stack.append((s, index, step, rf))


def _close() -> None:
    _, index, _, rf = _stack.pop()
    if index >= 0:
        _spans[index][2] = time.perf_counter_ns()
    if rf is not None:
        rf.__exit__(None, None, None)


def _record(name: str, value) -> None:
    global _dropped
    if threading.get_ident() != _owner:
        return
    if len(_counts) < CAPACITY:
        _counts.append((_stack[-1][1] if _stack else -1, name, value))
    else:
        _dropped += 1


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``; while the tracer is on, also
    record it against the innermost open span."""
    _totals[name] = _totals.get(name, 0) + n
    if _on:
        _record(name, n)


def count_device(name: str, tensor: torch.Tensor) -> None:
    """While the tracer is on, count ``tensor``'s sum under ``name``
    against the innermost open span, keeping a reference and reducing it
    only when :func:`counts` reads it; nothing while the tracer is off."""
    global _kept_tensors, _dropped
    if _on and threading.get_ident() == _owner:
        if _kept_tensors < DEVICE_CAPACITY:
            _kept_tensors += 1
            _record(name, tensor)
        else:
            _dropped += 1


def enable() -> None:
    """Turn the tracer on for the calling thread, keeping what it recorded
    before, and take the clock anchor; a no-op where it is on already."""
    global _on, _owner, _anchor_ns
    if _on:
        return
    _owner = threading.get_ident()
    _anchor_ns = time.time_ns() - time.perf_counter_ns()
    _on = True


def disable() -> None:
    """Turn the tracer off; open spans still close, and the record stays."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def clear() -> None:
    """Empty the record (spans open now end unrecorded).  The counters'
    process-wide totals stay."""
    global _kept_tensors, _dropped, _next_step
    _spans.clear()
    _counts.clear()
    _stack[:] = [(s, -1, step, rf) for s, _, step, rf in _stack]
    _kept_tensors = _dropped = _next_step = 0


def spans() -> List[SpanRecord]:
    """Every recorded span, in the order they opened."""
    return [SpanRecord(*x) for x in _spans]


def counts() -> List[CountRecord]:
    """Every recorded count, in order; a tensor counted by
    :func:`count_device` is summed here (a host read)."""
    return [CountRecord(at, name, int(v.sum()) if torch.is_tensor(v) else v)
            for at, name, v in _counts]


def total(name: str) -> int:
    """The counter's process-wide total from :func:`count`."""
    return _totals.get(name, 0)


def dropped() -> int:
    """Spans and counts left out of a full record since the last clear."""
    return _dropped


def trace_us(t_ns: int, base_time_ns: int) -> float:
    """A recorded ``perf_counter_ns`` time on the timeline of a Chrome trace
    whose ``baseTimeNanoseconds`` is ``base_time_ns``, in microseconds."""
    return (t_ns + _anchor_ns - base_time_ns) / 1e3


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (CPU activity, plus CUDA
    activity where a CUDA device exists) and export a Chrome trace to
    ``log_dir/trace.json`` (viewable in Perfetto).  The tracer is on for
    the block (and off after it, unless it was on before), so the port's
    spans are ranges of the trace.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = _on
    enable()
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        if not was_on:
            disable()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Decorator labelling each call of the function as ``name``: the
    decorator form of :func:`span`."""
    return span(name)


def aggregate_trace(path: str, cat: str = "kernel", within: Optional[list] = None):
    """Sum the complete events of category ``cat`` of a Chrome trace (a
    file, or a directory holding ``trace.json``) by name.

    ``cat="kernel"`` is torch.profiler's CUDA kernels (device time);
    ``"cpu_op"`` its CPU operators, which nest, so their sums overlap.
    Returns ``(us, calls, within_us)``: Counters of microseconds and calls
    by name, and for each name in ``within`` (``annotate``/
    ``record_function`` labels) the microseconds of the ``cat`` events
    launched inside a range so labelled (a kernel by its launch on the
    host, matched through the trace's correlation ids; a CPU operator by
    its start).  The profiler can drop records from a window; the sums are
    of what it kept.
    """
    if os.path.isdir(path):
        path = os.path.join(path, TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    us, calls = collections.Counter(), collections.Counter()
    picked = [e for e in events
              if e.get("ph") == "X" and str(e.get("cat", "")).lower() == cat]
    for e in picked:
        us[e["name"]] += e.get("dur", 0)
        calls[e["name"]] += 1
    within_us = {}
    if within:
        launch_ts = {}
        if cat == "kernel":
            for e in events:
                if e.get("ph") == "X" and e.get("cat") == "cuda_runtime":
                    corr = (e.get("args") or {}).get("correlation")
                    if corr is not None:
                        launch_ts[corr] = e["ts"]
        for name in within:
            ranges = _merged((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                             and e.get("name") == name)
            starts = [r[0] for r in ranges]
            total = 0
            for e in picked:
                ts = (launch_ts.get((e.get("args") or {}).get("correlation"))
                      if cat == "kernel" else e["ts"])
                k = -1 if ts is None else bisect.bisect_right(starts, ts) - 1
                if k >= 0 and ts <= ranges[k][1]:
                    total += e.get("dur", 0)
            within_us[name] = total
    return us, calls, within_us


def _merged(ranges) -> list:
    """Sorted disjoint unions of (start, end) ranges."""
    out = []
    for start, end in sorted(ranges):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def device_metrics(traj_done: torch.Tensor, traj_reward: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Reduce a [T, B] rollout to scalar metrics on its device."""
    episodes = traj_done.to(torch.int32).sum(dtype=torch.int32)
    return {
        "env_steps": torch.tensor(traj_done.numel(), dtype=torch.int32,
                                  device=traj_done.device),
        "episodes": episodes,
        "return_sum": traj_reward.sum(),
        "success_rate": torch.where(
            episodes > 0,
            torch.where(traj_done, traj_reward, 0.0).sum() / episodes,
            0.0,
        ),
    }


class Meter:
    """Steps/s + running episode stats, fed once per log interval."""

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.steps = 0
        self.episodes = 0
        self.return_sum = 0.0

    def update(self, m: Dict[str, Any]) -> None:
        """``m``: ``device_metrics`` output (tensors or numbers)."""
        self.steps += int(m["env_steps"])
        self.episodes += int(m["episodes"])
        self.return_sum += float(m["return_sum"])

    def snapshot(self) -> Dict[str, float]:
        dt = time.perf_counter() - self.t0
        return {
            "steps_per_sec": self.steps / dt if dt > 0 else 0.0,
            "env_steps": float(self.steps),
            "episodes": float(self.episodes),
            "mean_return": (
                self.return_sum / self.episodes if self.episodes else 0.0
            ),
            "elapsed_s": dt,
        }

