"""The multi-player cell (``multi_player_2p.device_loop_players_4096``) on the
CPU at a small size: sound, it reads 0 on all six counts; with a planted
fault (the sprites not drawn, both converging movers moved, the actions'
player axis reversed, the player axis summed away in the column sums) it
does not; its control (``control_players.py``, the reference in bfloat16)
comes out not correct; its four readers on a synthetic record and trace,
silent against a program without the spans."""

import dataclasses
import types

import pytest
import torch

from benchmark import check, control_players, harness, profile_trace, program_spans
from benchmark.drivers import device_loop_players
from benchmark.metrics import (player_cast_device_ms, player_cast_host_ms,
                               sprite_overlay_host_ms, sprite_overlay_roofline)
from benchmark.sut import Port
from raycastworlds_tpu_torch.models import multi_player
from raycastworlds_tpu_torch.ops import render
from raycastworlds_tpu_torch.utils import profiling

CELL = "multi_player_2p.device_loop_players_4096"
SEED = 2**31 + 2**22 + 9
# 512 envs in a 3 x 4 interior: the players meet and converge within the
# 24 warm-up steps, whatever the window holds
SMALL = {"env": {"num_rays": 16, "height_camera_view_pu": 8, "height_tile_map_tu": 5,
                 "width_tile_map_tu": 6},
         "traffic": {"num_envs": 512, "warmup_steps": 24}}
METRICS = {"player_cast_host_ms", "player_cast_device_ms", "sprite_overlay_host_ms",
           "sprite_overlay_roofline"}


def run(program=None, trace=False):
    return harness.run(CELL, SEED, 0.5, trace, t0=0.0, device="cpu", program=program,
                       overrides=SMALL)


def config(small=False):
    cfg = harness.load_config(harness.cell_of(harness.load_bench(), CELL)["config"])
    return dict(cfg, env=dict(cfg["env"], **SMALL["env"])) if small else cfg


def test_sound_port_reads_zero():
    r = run()
    assert r["correct"] is True
    assert set(r["checks"]) == set(check.NAMES)
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert set(r["metrics"]) == {"env_steps_per_s", "setup_s"}


class Unseen(Port):
    """The other players not drawn: no sprite over any frame."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.game = type(self.game)(dataclasses.replace(self.game.cfg, players_visible=False))


class BothMove(Port):
    """Of two converging movers both move: the lower-index rule left out
    (each candidate reads as far from every other candidate)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        step_batch = self.game.step_batch

        def step(state, action):
            real = multi_player._dist_sq

            def apart(a, c):
                d = real(a, c)
                return torch.full_like(d, float("inf")) if a is c else d

            multi_player._dist_sq = apart
            try:
                return step_batch(state, action)
            finally:
                multi_player._dist_sq = real

        self.game.step_batch = step


class Swapped(Port):
    """Each env's actions applied to its players in reverse order."""

    def env(self, num_envs, device):
        env = super().env(num_envs, device)
        step = env.step
        env.step = lambda state, action: step(state, action.flip(-1))
        return env


@pytest.mark.parametrize("fault", [Unseen, BothMove, Swapped])
def test_fault_is_caught(fault):
    r = run(fault(config(small=True)))
    assert r["correct"] is False, r["checks"]
    assert max(c["value"] for c in r["checks"].values()) > 0


def test_player_axis_summed_away_is_caught(monkeypatch):
    """The driver adds each column's sum over both players to each player's
    total."""

    def consume(self, obs):
        self.obs = obs
        self.cols += obs.view(torch.int32).sum(dim=(1, 2), dtype=torch.int64)[:, None]

    monkeypatch.setattr(device_loop_players.Driver, "_consume", consume)
    r = run()
    assert r["correct"] is False and r["checks"]["col_sums_off"]["value"] > 0, r["checks"]


@pytest.mark.parametrize("dtype,correct", [(torch.bfloat16, False), (torch.float32, True)])
def test_control(dtype, correct):
    r = control_players.run(CELL, SEED, 0.5, device="cpu", dtype=dtype, overrides=SMALL)
    assert r["correct"] is correct, r["checks"]


def test_traced_cpu_run_reads_the_host_side():
    profiling.enable()  # on since the readers' import, unless a test turned it off
    r = run(trace=True)
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    # on the CPU no kernel runs: the device-trace readers stay silent
    assert set(m) == {"player_cast_host_ms", "sprite_overlay_host_ms"}
    assert m["player_cast_host_ms"] > 0 and m["sprite_overlay_host_ms"] > 0


# -- the readers on a synthetic record and trace ----------------------------

US = 1000  # ns per us


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


class FakeTracer:
    """Spans (name, start us, end us, parent) in the tracer's record form."""

    def __init__(self, spans):
        self._spans = [profiling.SpanRecord(n, s * US, e * US, p, 0) for n, s, e, p in spans]

    def spans(self):
        return self._spans

    def counts(self):
        return []


def _ctx():
    host = profile_trace.Trace([_x("user_annotation", profile_trace.STEP_LABEL, s, 900)
                                for s in (1000, 2000)])
    return types.SimpleNamespace(host=host, config=config(), traffic={"num_envs": 4096})


def test_host_ms_readers(monkeypatch):
    spans = [("rcw.env.step", 1000, 1900, -1), ("rcw.game.observe_batch", 1100, 1800, 0),
             ("rcw.game.cast_players", 1100, 1400, 1), ("rcw.ops.sprite_overlay", 1500, 1550, 1),
             ("rcw.env.step", 2000, 2900, -1), ("rcw.game.observe_batch", 2100, 2800, 4),
             ("rcw.game.cast_players", 2100, 2200, 5), ("rcw.ops.sprite_overlay", 2300, 2330, 5),
             ("rcw.game.cast_players", 100, 900, -1),     # before the stretch
             ("rcw.ops.sprite_overlay", 100, 900, -1)]
    monkeypatch.setattr(program_spans, "profiling", FakeTracer(spans))
    assert player_cast_host_ms.read(None, _ctx()) == pytest.approx((0.3 + 0.1) / 2)
    assert sprite_overlay_host_ms.read(None, _ctx()) == pytest.approx((0.05 + 0.03) / 2)


def _device_trace():
    """Two profiled steps: per step a cast span with two kernels launched
    inside it (the second step's one running on past the span's end), an
    overlay span with one kernel, and a kernel launched outside both."""
    ev = []
    for k, t in enumerate((0, 1000)):
        c = 10 * k
        ev += [_x("user_annotation", profile_trace.STEP_LABEL, t, 900),
               _x("user_annotation", "rcw.game.cast_players", t + 10, 100),
               _x("cuda_runtime", "cudaLaunchKernel", t + 20, 1, c),
               _x("kernel", "crossing_cast", t + 30, 40, c),
               _x("cuda_runtime", "cudaLaunchKernel", t + 60, 1, c + 1),
               _x("kernel", "where", t + 80, 60 + 100 * k, c + 1),
               _x("user_annotation", "rcw.ops.sprite_overlay", t + 300, 50),
               _x("cuda_runtime", "cudaLaunchKernel", t + 310, 1, c + 2),
               _x("kernel", "where", t + 320, 200, c + 2),
               _x("cuda_runtime", "cudaLaunchKernel", t + 600, 1, c + 3),
               _x("kernel", "other", t + 850, 30, c + 3)]
    return profile_trace.Trace(ev)


def test_device_readers():
    trace = _device_trace()
    assert trace.steps == 2
    assert player_cast_device_ms.read(trace, _ctx()) == pytest.approx((40 + 60 + 40 + 160)
                                                                       / 2 / 1e3)
    # two overlays of 8192 64 x 64 frames in 400 us against 0.0814 ms each
    bound_s = 272629760 / 3.35e12
    assert sprite_overlay_roofline.read(trace, _ctx()) == pytest.approx(
        100 * 2 * bound_s / 400e-6)


def test_sprite_overlay_work():
    assert sprite_overlay_roofline.sprite_overlay_work(8192, 64, 64) == (
        8 * 8192 * 64 * 64 + 8 * 8192 * 64, 0)


def test_silent_without_the_spans(monkeypatch):
    monkeypatch.setattr(program_spans, "profiling", None)
    bare = profile_trace.Trace([_x("user_annotation", profile_trace.STEP_LABEL, 0, 90),
                                _x("cuda_runtime", "cudaLaunchKernel", 10, 1, 1),
                                _x("kernel", "k", 20, 10, 1)])
    for mod in (player_cast_host_ms, player_cast_device_ms, sprite_overlay_host_ms,
                sprite_overlay_roofline):
        assert mod.read(bare, _ctx()) is None


class Unspanned(Port):
    """A MultiPlayerRoom whose cast opens no ``rcw.game.cast_players`` span,
    as before the span was added."""

    def __init__(self, cfg):
        super().__init__(cfg)
        bare = type(self.game)._cast_players.__wrapped__
        self.game._cast_players = types.MethodType(bare, self.game)


def test_silent_against_a_program_without_the_spans(monkeypatch):
    monkeypatch.setattr(render, "sprite_overlay", render.sprite_overlay.__wrapped__)
    r = harness.run(CELL, SEED, 0.5, True, t0=0.0, device="cpu",
                    program=Unspanned(config(small=True)), overrides=SMALL)
    assert r["correct"] is True
    assert not set(r["metrics"]) & METRICS


@pytest.mark.cuda
def test_small_traced_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's kernels have no CPU mode)")
    profiling.enable()  # on since the readers' import, unless a test turned it off
    r = harness.run(CELL, SEED, 1.0, True, t0=0.0, device=torch.device("cuda", 0),
                    overrides=SMALL)
    assert r["correct"] is True, r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == METRICS
    assert m["player_cast_device_ms"] > 0 and 0 < m["sprite_overlay_roofline"] <= 100
