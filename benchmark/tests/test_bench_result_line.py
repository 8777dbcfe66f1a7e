"""The result line's keys, from whole runs on the CPU at small sizes, and
the command's refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

SMALL = {"traffic": {"num_envs": 8, "warmup_steps": 2}}
DEVICE = "single_room_64.device_loop_4096"
HOST = "single_room_64.host_loop_4096"


def line(workload, trace):
    return harness.run(workload, 2**32 + 5, 0.5, trace, t0=0.0, device="cpu",
                       overrides=SMALL)


@pytest.mark.parametrize("workload", [DEVICE, HOST])
def test_untraced_line(workload):
    r = line(workload, False)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    bench = harness.load_bench()
    expected = {m["name"] for m in bench["end_to_end"] if harness.applies(m, workload)}
    assert set(r["metrics"]) == expected
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["checks"].values())
    json.dumps(r)


@pytest.mark.parametrize("workload", [DEVICE, HOST])
def test_traced_line(workload):
    r = line(workload, True)
    assert list(r)[-2:] == ["breakdown", "checks"]
    assert r["correct"] is True
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in r["breakdown"].values())
    bench = harness.load_bench()
    allowed = {m["name"] for m in bench["per_layer"] if harness.applies(m, workload)}
    # on the CPU only the host spans have something to read
    assert "host_enqueue_ms" in r["metrics"] and set(r["metrics"]) <= allowed
    if workload == HOST:
        assert r["metrics"]["adapter_self_ms"]["value"] >= 0


def test_spans_come_off_again():
    import raycastworlds_tpu_torch as rt

    before = rt.Env.step, rt.rng.threefry2x32, rt.ops.render.render_observation
    line(DEVICE, True)
    assert (rt.Env.step, rt.rng.threefry2x32, rt.ops.render.render_observation) == before


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", DEVICE, "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_refuses_without_a_card():
    p = _run_py(harness.ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
