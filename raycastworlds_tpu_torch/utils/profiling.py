"""Profiling, tracing and metrics helpers.

The port of the JAX package's ``utils/profiling.py``:

* :func:`trace` -- context manager around ``torch.profiler`` (CPU and, where
  there is one, CUDA activity) writing a Chrome trace into a directory;
* :func:`annotate` -- decorator labelling a function's range in traces
  (``torch.profiler.record_function``);
* :func:`aggregate_trace` -- a trace's device time, summed by kernel name,
  and the part of it launched inside each annotated range;
* :class:`Meter` -- host-side steps/s and episode statistics, fed once per
  log interval;
* :func:`device_metrics` -- a [T, B] rollout reduced to scalar metrics on
  its device.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (CPU activity, plus CUDA
    activity where a CUDA device exists) and export a Chrome trace to
    ``log_dir/trace.json`` (viewable in Perfetto).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Decorator labelling each call of the function as ``name`` in
    profiler traces."""

    def deco(fn):
        def wrapped(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)

        return wrapped

    return deco


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

