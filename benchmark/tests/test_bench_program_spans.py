"""The readers of the program's own spans and counters
(``program_spans.py`` and the five metrics that use it) on a synthetic
record and a synthetic trace, silent against a program without a tracer,
and whole traced runs on the CPU that read the host-side ones."""

import importlib
import types

import pytest

from benchmark import harness, profile_trace, program_spans
from benchmark.metrics import (host_copy_gbps, idle_in_program_share, reset_host_ms,
                               reset_useful_share, threefry_host_ms)
from raycastworlds_tpu_torch.utils import profiling

US = 1000  # ns per us


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _host(*steps):
    """The harness's host stretch: its step spans, in us."""
    return profile_trace.Trace([_x("user_annotation", profile_trace.STEP_LABEL, s, e - s)
                                for s, e in steps])


class FakeTracer:
    """Spans (name, start us, end us, parent) and counts (span, name,
    value) in the program tracer's record form."""

    def __init__(self, spans, counts):
        self._spans = [profiling.SpanRecord(n, s * US, e * US, p, 0) for n, s, e, p in spans]
        self._counts = [profiling.CountRecord(*c) for c in counts]

    def spans(self):
        return self._spans

    def counts(self):
        return self._counts


@pytest.fixture
def record(monkeypatch):
    """Two host steps in [1000, 3000] us; a step before the stretch."""
    spans = [
        ("rcw.env.step", 1000, 1900, -1),        # 0
        ("rcw.env.reset", 1100, 1600, 0),        # 1
        ("rcw.rng.threefry", 1200, 1400, 1),     # 2
        ("rcw.rng.threefry", 1250, 1300, 2),     # 3: nested, counted once
        ("rcw.env.step", 2000, 2900, -1),        # 4
        ("rcw.env.reset", 2100, 2300, 4),        # 5
        ("rcw.rng.threefry", 2100, 2200, 5),     # 6
        ("rcw.gym.to_host", 2500, 2800, 4),      # 7
        ("rcw.env.step", 100, 900, -1),          # 8: before the stretch
        ("rcw.rng.threefry", 100, 800, 8),       # 9
        ("rcw.env.reset", 100, 800, 8),          # 10
    ]
    counts = [(0, "episodes_ended", 3), (1, "reset_rows", 4096),
              (4, "episodes_ended", 0), (5, "reset_rows", 4096),
              (7, "host_copy_bytes", 3000), (4, "host_copy_bytes", 99),
              (10, "reset_rows", 4096), (8, "episodes_ended", 5),
              (-1, "host_copy_bytes", 7)]
    monkeypatch.setattr(program_spans, "profiling", FakeTracer(spans, counts))
    return types.SimpleNamespace(host=_host((1000, 1950), (2000, 3000)))


def test_host_ms_per_step(record):
    assert threefry_host_ms.read(None, record) == pytest.approx((0.2 + 0.1) / 2)
    assert reset_host_ms.read(None, record) == pytest.approx((0.5 + 0.2) / 2)


def test_reset_useful_share(record):
    assert reset_useful_share.read(None, record) == pytest.approx(100.0 * 3 / 8192)


def _device_trace():
    """Two profiled steps: per step a kernel, a DtoH copy launched inside
    ``rcw.gym.to_host`` (1 us, then 3 us) and one launched outside it, and
    an HtoD copy inside it."""
    ev = []
    for k, (t, copy_us) in enumerate([(0, 1), (100, 3)]):
        c = 10 * k
        ev += [_x("user_annotation", profile_trace.STEP_LABEL, t, 90),
               _x("user_annotation", "rcw.gym.step", t + 5, 80),
               _x("user_annotation", "rcw.env.step", t + 5, 40),
               _x("user_annotation", "rcw.gym.to_host", t + 50, 30),
               _x("cuda_runtime", "cudaLaunchKernel", t + 10, 1, c),
               _x("kernel", "k", t + 20, 10, c),
               _x("cuda_runtime", "cudaMemcpyAsync", t + 55, 1, c + 1),
               _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", t + 60, copy_us, c + 1),
               _x("cuda_runtime", "cudaMemcpyAsync", t + 56, 1, c + 2),
               _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", t + 70, 5, c + 2),
               _x("cuda_runtime", "cudaMemcpyAsync", t + 85, 1, c + 3),
               _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", t + 86, 2, c + 3)]
    return profile_trace.Trace(ev)


def test_host_copy_gbps(record):
    trace = _device_trace()
    assert trace.steps == 2
    # 3000 bytes over the host stretch's 2 steps, in 2 us of copies a step
    assert host_copy_gbps.read(trace, record) == pytest.approx(1500 / 2e-6 / 1e9)


def test_idle_in_program_share():
    trace = _device_trace()
    window = trace.window
    assert window == (0, 190)
    idle = sum(length for _, length in trace.idle_gaps())
    busy = [(20, 30), (60, 61), (70, 75), (86, 88), (120, 130), (160, 163), (170, 175),
            (186, 188)]
    assert idle == pytest.approx(190 - sum(e - s for s, e in busy))
    # rcw.gym.step covers [5, 85] and [105, 185]: the busy parts inside them
    # are (20, 30), (60, 61), (70, 75), (120, 130), (160, 163), (170, 175)
    inside = 80 + 80 - (10 + 1 + 5 + 10 + 3 + 5)
    assert idle_in_program_share.read(trace, None) == pytest.approx(100.0 * inside / idle)


def test_silent_without_the_tracer(monkeypatch):
    monkeypatch.setattr(program_spans, "profiling", None)
    ctx = types.SimpleNamespace(host=_host((0, 10)))
    trace = _device_trace()
    for mod in (threefry_host_ms, reset_host_ms, reset_useful_share, host_copy_gbps):
        assert mod.read(trace, ctx) is None
    bare = profile_trace.Trace([_x("user_annotation", profile_trace.STEP_LABEL, 0, 90),
                                _x("cuda_runtime", "cudaLaunchKernel", 10, 1, 1),
                                _x("kernel", "k", 20, 10, 1)])
    assert idle_in_program_share.read(bare, ctx) is None


def test_no_span_name_is_a_harness_label():
    bench = harness.load_bench()
    labels = {label for m in bench["per_layer"] for label in importlib.import_module(
        f"benchmark.metrics.{m['name']}").SPANS}
    labels |= {profile_trace.STEP_LABEL, profile_trace.PROFILER_STEP}
    assert "env.Env.step" in labels
    assert not any(label.startswith("rcw.") for label in labels)


@pytest.mark.parametrize("workload", ["single_room_64.device_loop_4096",
                                      "single_room_64.host_loop_4096"])
def test_traced_cpu_run_reads_the_host_side(workload):
    r = harness.run(workload, 2**32 + 9, 0.5, True, t0=0.0, device="cpu",
                    overrides={"traffic": {"num_envs": 8, "warmup_steps": 2}})
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["threefry_host_ms"] > 0 and m["reset_host_ms"] >= m["threefry_host_ms"]
    assert 0 <= m["reset_useful_share"] <= 100
    # no device on the CPU: the device-trace readers stay silent
    assert "host_copy_gbps" not in m and "idle_in_program_share" not in m
    assert r["metrics"]["reset_useful_share"]["unit"] == "%"
