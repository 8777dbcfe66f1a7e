"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), the check against the plain reference, the result line.

Everything that belongs to a cell is found by name from ``BENCHMARK.json``:
the configuration ``configs/<config>.json``, the traffic mix
``traffic/<traffic>.json`` and the loop driver it names
(``drivers/<driver>.py``), and each per-layer metric
``metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names no run may load: JAX, and the JAX package the port
# was made from (compared whole: the port's own name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "raycastworlds_tpu")


class NoDevice(RuntimeError):
    """The cell's chips are not there."""


def load_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_bench() -> Dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_of(bench: Dict, name: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str) -> Dict:
    return load_json(BENCH_DIR, "configs", f"{name}.json")


def load_traffic(name: str) -> Dict:
    return load_json(BENCH_DIR, "traffic", f"{name}.json")


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_modules(bench: Dict, cell: str) -> List:
    """(name, module) of each per-layer metric the cell reports."""
    return [(m["name"], importlib.import_module(f"benchmark.metrics.{m['name']}"))
            for m in bench["per_layer"] if applies(m, cell)]


def forbidden_loaded() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(workload: str, seed: int, seconds: float, trace: bool, *, t0: float,
        device=None, program=None, overrides: Optional[Dict] = None) -> Dict:
    """Run the cell once and return the result line as a dict.  ``device``
    None is the first CUDA device (NoDevice where the cell's chips are not
    there); ``program`` None is the port; ``overrides`` replaces keys of the
    configuration's ``env`` and of the traffic (tests run cells small)."""
    import torch

    bench = load_bench()
    cell = cell_of(bench, workload)
    config = load_config(cell["config"])
    traffic = load_traffic(cell["traffic"])
    if overrides:
        config = dict(config, env=dict(config["env"], **overrides.get("env", {})))
        traffic = dict(traffic, **overrides.get("traffic", {}))
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"{workload} needs {cell['chips']} CUDA device(s); "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                           "found")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if program is None:
        from .sut import Port

        program = Port(config)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}").Driver(
        program, config, traffic, seed, device)
    setup_s = time.perf_counter() - t0
    measured = driver.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics: Dict[str, Dict] = {}
    result_device = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": int(peak),
    }
    breakdown = None
    if trace:
        from . import tracing

        values, busy_s, window_s, breakdown = tracing.run(
            driver, metric_modules(bench, workload), config, traffic, device)
        result_device.update(busy_s=busy_s, window_s=window_s)
        for m in bench["per_layer"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        measured["setup_s"] = setup_s
        for m in bench["end_to_end"]:
            if applies(m, workload) and m["name"] in measured:
                metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    outputs = driver.outputs()
    del driver, program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from . import check

    started = time.perf_counter()
    checks = check.compare(config, outputs, device)
    print(f"reference check of {outputs['steps']} steps x {outputs['num_envs']} envs: "
          f"{time.perf_counter() - started:.1f} s", file=sys.stderr)
    result = {
        "correct": all(v <= lim for _, v, lim in checks),
        "attempted": measured["attempted"],
        "failed": 0,
        "metrics": metrics,
        "device": result_device,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result


def parse_args(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace), t0=t0)
    except NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    leaked = forbidden_loaded()
    if leaked:
        print(f"no result: the run loaded {', '.join(leaked)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
