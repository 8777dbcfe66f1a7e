"""The traced stretches of a ``--trace 1`` run.

The harness wraps the program calls that the cell's per-layer metrics name
(their ``SPANS``) in spans, then steps two stretches of whole steps:

* the host stretch, with no profiler running: each span's host clock is
  kept in memory, so host times are read without the profiler's cost
  (which about doubles a step's host time);
* the device stretch, under ``torch.profiler`` (CPU and CUDA activity; the
  first steps warm the profiler and are discarded): the spans are
  ``record_function`` ranges, the Chrome trace goes into a fresh directory
  under the run's temporary directory, is read and deleted.

Both are read as ``profile_trace.Trace``.  The program itself is not
changed: the wrappers sit on the objects and module attributes the harness
reached, and come off again.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import shutil
import tempfile
import time
import types
from typing import Dict, List

import torch

from . import profile_trace

TRACE_STEPS = 12
TRACE_WARMUP = 2


def _resolve(target: str, objects: Dict):
    """(owner, attribute) of a span target, or None where it does not
    resolve in this run."""
    if ":" in target:
        module, path = target.split(":")
        owner = importlib.import_module(module)
    else:
        name, path = target.split(".", 1)
        owner = objects.get(name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p, None)
    if owner is None or not hasattr(owner, parts[-1]):
        return None
    return owner, parts[-1]


def _host_event(events, label, start):
    end = time.perf_counter()
    events.append({"ph": "X", "cat": "user_annotation", "name": label,
                   "ts": start * 1e6, "dur": (end - start) * 1e6})


def install(spans: Dict[str, str], objects: Dict, keep, kept: Dict[str, list],
            host_events: list, timing: Dict[str, bool]):
    """Wrap each target in a span named by its label; returns the undo
    list.  Calls of a label in ``keep`` append their arguments to
    ``kept[label]``; while ``timing["on"]``, each call's host clock span
    goes to ``host_events`` as a trace event."""
    undo = []
    for label, target in spans.items():
        found = _resolve(target, objects)
        if found is None:
            continue
        owner, attr = found
        had = attr in vars(owner)
        raw = vars(owner).get(attr)
        fn = getattr(owner, attr)

        def wrapped(*args, _fn=fn, _label=label, **kwargs):
            if _label in keep:
                kept.setdefault(_label, []).append(args)
            start = time.perf_counter()
            try:
                with torch.profiler.record_function(_label):
                    return _fn(*args, **kwargs)
            finally:
                if timing["on"]:
                    _host_event(host_events, _label, start)

        functools.update_wrapper(wrapped, fn)
        setattr(owner, attr, wrapped)
        undo.append((owner, attr, had, raw))
    return undo


def uninstall(undo) -> None:
    for owner, attr, had, raw in reversed(undo):
        if had:
            setattr(owner, attr, raw)
        else:
            delattr(owner, attr)


def run(driver, metrics: List, config: Dict, traffic: Dict, device):
    """Trace TRACE_STEPS steps of ``driver`` on the host clock, then
    TRACE_STEPS under the profiler; returns (metric values by name, device
    busy seconds, traced window seconds, breakdown).  ``metrics`` is a list
    of (name, module)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    spans, keep = {}, set()
    for _, mod in metrics:
        for label, target in mod.SPANS.items():
            if spans.setdefault(label, target) != target:
                raise ValueError(f"span {label} names two targets")
        keep.update(getattr(mod, "KEEP", ()))
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    tmp = tempfile.mkdtemp(prefix="bench-trace-")
    path = os.path.join(tmp, "trace.json")
    kept: Dict[str, list] = {}
    host_events: list = []
    timing = {"on": True}
    undo = install(spans, driver.objects, keep, kept, host_events, timing)
    try:
        for _ in range(TRACE_STEPS):
            start = time.perf_counter()
            driver.step()
            _host_event(host_events, profile_trace.STEP_LABEL, start)
        driver.sync()
        timing["on"] = False
        host = profile_trace.Trace(host_events)
        total = TRACE_WARMUP + TRACE_STEPS
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=TRACE_WARMUP, active=TRACE_STEPS),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for i in range(total):
                if i == TRACE_WARMUP:
                    kept.clear()
                with torch.profiler.record_function(profile_trace.STEP_LABEL):
                    driver.step()
                if i == total - 1:
                    driver.sync()
                prof.step()
        with open(path) as f:
            trace = profile_trace.Trace(json.load(f)["traceEvents"])
    finally:
        uninstall(undo)
        shutil.rmtree(tmp, ignore_errors=True)
    ctx = types.SimpleNamespace(steps=trace.steps, kept=kept, config=config,
                                traffic=traffic, device=device, host=host)
    values = {}
    for name, mod in metrics:
        v = mod.read(trace, ctx)
        if v is not None:
            values[name] = float(v)
    return values, trace.busy_us() / 1e6, trace.window_us / 1e6, trace.breakdown()
