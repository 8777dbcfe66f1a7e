"""The maze cell (``maze_17x17.device_loop_32768``) on the CPU at a small
size: sound, it reads 0 on all six counts; with a planted fault (one wall
bit of one generated maze flipped, the rooms left uncarved, the budget
applied as a dense reset) it does not; its control (``control_maze.py``,
the reference in bfloat16) comes out not correct; its three readers on a
synthetic record and trace, silent against a program without the span."""

import dataclasses
import types

import pytest
import torch

from benchmark import check, control_maze, harness, profile_trace, program_spans
from benchmark.metrics import maze_reset_device_ms, maze_reset_host_ms, maze_reset_launches
from benchmark.sut import Port
from raycastworlds_tpu_torch.utils import profiling

CELL = "maze_17x17.device_loop_32768"
SEED = 2**31 + 2**22 + 9
# 640 envs whose episodes all truncate at step 3: more than the budget of
# 512 end at once, so envs wait for their reset
SMALL = {"env": {"num_rays": 16, "height_camera_view_pu": 8, "max_episode_steps": 3},
         "traffic": {"num_envs": 640, "warmup_steps": 3}}


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


class FlippedWall(Port):
    """Every generated reset has one wall bit of its first row's maze
    flipped: an interior tile that is neither the goal nor the spawn."""

    def __init__(self, cfg):
        super().__init__(cfg)
        reset_batch = self.game.reset_batch

        def flipped(keys):
            state = reset_batch(keys)
            walls = state.wall_map.clone()
            goal = tuple(state.goal_tu[0].tolist())
            spawn = tuple(state.pos_wu[0].floor().to(torch.int64).tolist())
            tile = next((i, j) for i in range(1, walls.shape[1] - 1)
                        for j in range(1, walls.shape[2] - 1) if (i, j) not in (goal, spawn))
            walls[(0,) + tile] ^= True
            return state.replace_walls(walls)

        self.game.reset_batch = flipped


class Uncarved(Port):
    """The mazes without their rooms: the corridors alone."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.game = type(self.game)(dataclasses.replace(self.game.cfg, num_rooms=0))


class DenseReset(Port):
    """The budget ignored: every env that ends resets in the same step."""

    def __init__(self, cfg):
        super().__init__(cfg)
        env = self.rt.Env
        self.rt = types.SimpleNamespace(
            Env=lambda game, n, device, reset_budget: env(game, n, device=device))


@pytest.mark.parametrize("fault", [FlippedWall, Uncarved, DenseReset])
def test_fault_is_caught(fault):
    r = run(fault(config(small=True)))
    assert r["correct"] is False, r["checks"]
    assert max(c["value"] for c in r["checks"].values()) > 0


@pytest.mark.parametrize("dtype,correct", [(torch.bfloat16, False), (torch.float32, True)])
def test_control(dtype, correct):
    r = control_maze.run(CELL, SEED, 0.5, device="cpu", dtype=dtype, overrides=SMALL)
    assert r["correct"] is correct, r["checks"]


def test_traced_cpu_run_reads_the_host_side():
    profiling.enable()  # on since the readers' import, unless a test turned it off
    r = run(trace=True)
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    # on the CPU no kernel runs: the device-trace readers stay silent
    assert set(m) == {"maze_reset_host_ms"} and m["maze_reset_host_ms"] > 0


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
    return types.SimpleNamespace(host=host, config=config(), traffic={"num_envs": 32768})


def test_maze_reset_host_ms(monkeypatch):
    spans = [("rcw.env.step", 1000, 1900, -1), ("rcw.env.reset", 1100, 1600, 0),
             ("rcw.game.maze_reset", 1200, 1500, 1),
             ("rcw.env.step", 2000, 2900, -1), ("rcw.env.reset", 2100, 2400, 3),
             ("rcw.game.maze_reset", 2100, 2200, 4),
             ("rcw.game.maze_reset", 100, 900, -1)]       # before the stretch
    monkeypatch.setattr(program_spans, "profiling", FakeTracer(spans))
    assert maze_reset_host_ms.read(None, _ctx()) == pytest.approx((0.3 + 0.1) / 2)


def _device_trace():
    """Two profiled steps: per step a maze reset span with two kernels
    launched inside it (the second step's one running on past the span's
    end), and a kernel launched outside it."""
    ev = []
    for k, t in enumerate((0, 1000)):
        c = 10 * k
        ev += [_x("user_annotation", profile_trace.STEP_LABEL, t, 900),
               _x("user_annotation", "rcw.game.maze_reset", t + 10, 100),
               _x("cuda_runtime", "cudaLaunchKernel", t + 20, 1, c),
               _x("kernel", "threefry", t + 30, 40, c),
               _x("cuda_runtime", "cudaLaunchKernel", t + 60, 1, c + 1),
               _x("kernel", "where", t + 80, 60 + 100 * k, c + 1),
               _x("cuda_runtime", "cudaLaunchKernel", t + 400, 1, c + 2),
               _x("kernel", "other", t + 850, 30, c + 2)]
    return profile_trace.Trace(ev)


def test_maze_reset_device_ms_and_launches():
    trace = _device_trace()
    assert trace.steps == 2
    assert maze_reset_device_ms.read(trace, _ctx()) == pytest.approx((40 + 60 + 40 + 160)
                                                                      / 2 / 1e3)
    assert maze_reset_launches.read(trace, _ctx()) == 2


def test_silent_without_the_span(monkeypatch):
    monkeypatch.setattr(program_spans, "profiling", None)
    bare = profile_trace.Trace([_x("user_annotation", profile_trace.STEP_LABEL, 0, 90),
                                _x("cuda_runtime", "cudaLaunchKernel", 10, 1, 1),
                                _x("kernel", "k", 20, 10, 1)])
    for mod in (maze_reset_host_ms, maze_reset_device_ms, maze_reset_launches):
        assert mod.read(bare, _ctx()) is None


class Unspanned(Port):
    """A Maze whose reset opens no ``rcw.game.maze_reset`` span, as before
    the span was added."""

    def __init__(self, cfg):
        super().__init__(cfg)
        bare = type(self.game).reset_batch.__wrapped__
        self.game.reset_batch = types.MethodType(bare, self.game)


def test_silent_against_a_program_without_the_span():
    r = harness.run(CELL, SEED, 0.5, True, t0=0.0, device="cpu",
                    program=Unspanned(config(small=True)), overrides=SMALL)
    assert r["correct"] is True
    assert not set(r["metrics"]) & {"maze_reset_host_ms", "maze_reset_device_ms",
                                    "maze_reset_launches"}


@pytest.mark.cuda
def test_small_traced_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's kernels have no CPU mode)")
    profiling.enable()  # on since the readers' import, unless a test turned it off
    r = harness.run(CELL, SEED, 1.0, True, t0=0.0, device=torch.device("cuda", 0),
                    overrides=SMALL)
    assert r["correct"] is True, r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == {"maze_reset_host_ms", "maze_reset_device_ms", "maze_reset_launches"}
    assert m["maze_reset_device_ms"] > 0 and m["maze_reset_launches"] >= 1
