"""The port's tracer (``utils/profiling.py``): spans and counters at the
layer boundaries of ``Env.step`` and the adapters, off by default.

On the CPU at 16 rays x 16 px: off, a step records nothing and enters no
``record_function``; on, the spans nest with the right parents and step
ids, lie inside their ``record_function`` events of a ``profiling.trace``
on the trace's clock, and the counters (``reset_rows``, ``episodes_ended``,
``host_copy_bytes``, ``kernel_launches.<kernel>``, RandomRoom's
``flood_dilations`` and ``budget_resets``, Maze's ``maze_maps``,
MultiPlayerRoom's ``player_views``) count what the step did,
MultiPlayerRoom's cast and sprite spans open once an observation, and
Maze's reset kernel (emulated on the CPU) opens its span inside the
reset's; states, observations, rewards and dones are the same bit for bit
with the tracer on and off.  Imports no JAX (the ``cuda``
tests run on the card).
"""

import contextlib
import json
import os
import types

import numpy as np
import pytest
import torch

import maze_kernel_emulation
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch import cuda_build
from raycastworlds_tpu_torch.models import maze as maze_module
from raycastworlds_tpu_torch.utils import profiling

SMALL = dict(num_rays=16, height_camera_view_pu=16)


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


def _env(num_envs=4, reset_budget=0, device="cpu", **cfg):
    game = rt.SingleRoom(rt.EnvConfig(**SMALL, **cfg))
    return rt.Env(game, num_envs=num_envs, device=device, reset_budget=reset_budget)


def _actions(env, t):
    return env.sample_action(rt.rng.PRNGKey(100 + t))


def _run(env, steps, key=3):
    """Reset and ``steps`` steps: every step's result."""
    state, _ = env.reset(rt.rng.PRNGKey(key))
    out = []
    for t in range(steps):
        res = env.step(state, _actions(env, t))
        out.append(res)
        state = res.state
    return out


def _named(spans, name):
    return [i for i, s in enumerate(spans) if s.name == name]


def _summed(name, within=None):
    """The recorded counts of ``name``, summed; ``within``: only those
    recorded inside a span so named (or its descendants)."""
    spans = profiling.spans()

    def inside(i):
        while i >= 0:
            if spans[i].name == within:
                return True
            i = spans[i].parent
        return False

    return sum(c.value for c in profiling.counts()
               if c.name == name and (within is None or inside(c.span)))


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered")


def test_off_by_default_and_off_records_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    assert not profiling.enabled()
    env = _env()
    _run(env, 2)
    adapter = rt.GymVectorAdapter(env.game, 4, device="cpu")
    adapter.reset(seed=1)
    before = profiling.total("host_copy_bytes")
    adapter.step(np.zeros(4, np.int32))
    assert profiling.spans() == [] and profiling.counts() == []
    # the totals still count: the counters are a plain integer add
    assert profiling.total("host_copy_bytes") > before


def test_span_is_a_context_manager_and_a_decorator():
    @profiling.span("t.outer")
    def outer():
        with profiling.span("t.inner"):
            profiling.count("t.things", 3)
        return 7

    assert outer() == 7 and outer.__name__ == "outer"
    assert profiling.spans() == []
    profiling.enable()
    assert outer() == 7
    profiling.disable()
    spans = profiling.spans()
    assert [s.name for s in spans] == ["t.outer", "t.inner"]
    assert spans[0].parent == -1 and spans[1].parent == 0
    assert spans[0].step == spans[1].step
    assert spans[0].start_ns <= spans[1].start_ns <= spans[1].end_ns <= spans[0].end_ns
    assert profiling.counts() == [profiling.CountRecord(1, "t.things", 3)]
    assert profiling.total("t.things") == 6  # counted on and off
    assert profiling.annotate("t.outer") is profiling.span("t.outer")


def test_record_is_bounded_and_clear_keeps_totals(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    monkeypatch.setattr(profiling, "DEVICE_CAPACITY", 1)
    profiling.enable()
    for _ in range(5):
        with profiling.span("t.s"):
            profiling.count("t.n")
            profiling.count_device("t.d", torch.ones(2, dtype=torch.bool))
    assert len(profiling.spans()) == 3 and len(profiling.counts()) == 3
    # counts share one capacity: 2 spans, 3 host counts and 4 device counts
    # (one tensor kept at most) left out
    assert profiling.dropped() == 9
    assert _summed("t.d") == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0
    assert profiling.total("t.n") == 5


def test_env_step_spans_nest_with_parents_and_step_ids():
    env = _env()
    state, _ = env.reset(rt.rng.PRNGKey(3))
    actions = [_actions(env, t) for t in range(2)]
    profiling.enable()
    for a in actions:
        state = env.step(state, a).state
    profiling.disable()
    spans = profiling.spans()
    roots = _named(spans, "rcw.env.step")
    assert len(roots) == 2 and all(spans[i].parent == -1 for i in roots)
    assert spans[roots[0]].step != spans[roots[1]].step
    parent_of = {"rcw.game.step_batch": "rcw.env.step", "rcw.env.reset": "rcw.env.step",
                 "rcw.game.observe_batch": "rcw.env.step",
                 "rcw.game.cast_batch": "rcw.game.observe_batch",
                 "rcw.ops.render_observation": "rcw.game.observe_batch"}
    for child, parent in parent_of.items():
        found = _named(spans, child)
        assert len(found) == 2, child
        for i in found:
            assert spans[spans[i].parent].name == parent, child
    # the dense reset draws through threefry, inside rcw.env.reset
    threefry = _named(spans, "rcw.rng.threefry")
    assert threefry
    for i in threefry:
        up = spans[i].parent
        while spans[up].name != "rcw.env.reset":
            up = spans[up].parent
            assert up >= 0
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        root = i
        while spans[root].parent >= 0:
            p = spans[spans[root].parent]
            assert p.start_ns <= spans[root].start_ns and spans[root].end_ns <= p.end_ns
            root = spans[root].parent
        assert spans[root].name == "rcw.env.step" and s.step == spans[root].step


def test_adapter_step_spans():
    adapter = rt.GymVectorAdapter(rt.SingleRoom(rt.EnvConfig(**SMALL)), 4, device="cpu")
    adapter.reset(seed=2)
    profiling.enable()
    adapter.step(np.array([0, 1, 2, 3], np.int32))
    profiling.disable()
    spans = profiling.spans()
    (root,) = _named(spans, "rcw.gym.step")
    assert spans[root].parent == -1
    for name in ("rcw.env.step", "rcw.gym.to_host"):
        (i,) = _named(spans, name)
        assert spans[i].parent == root
    assert {s.step for s in spans} == {spans[root].step}


def test_spans_lie_inside_their_trace_events(tmp_path):
    env = _env()
    state, _ = env.reset(rt.rng.PRNGKey(5))
    with profiling.trace(str(tmp_path)):
        for t in range(2):
            state = env.step(state, _actions(env, t)).state
    assert not profiling.enabled()  # trace() put the switch back
    with open(tmp_path / profiling.TRACE_FILE) as f:
        doc = json.load(f)
    base = doc["baseTimeNanoseconds"]
    events = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            events.setdefault(e["name"], []).append(e)
    spans = profiling.spans()
    names = {s.name for s in spans}
    assert {"rcw.env.step", "rcw.env.reset", "rcw.rng.threefry"} <= names
    for name in names:
        mine = [s for s in spans if s.name == name]
        theirs = sorted(events.get(name, []), key=lambda e: e["ts"])
        assert len(mine) == len(theirs), name
        for s, e in zip(mine, theirs):
            start = profiling.trace_us(s.start_ns, base)
            end = profiling.trace_us(s.end_ns, base)
            assert e["ts"] - 50 <= start <= end <= e["ts"] + e["dur"] + 50, name


@pytest.mark.parametrize("budget", [0, 3])
def test_reset_rows(budget):
    env = _env(num_envs=8, reset_budget=budget)
    before = profiling.total("reset_rows")
    profiling.enable()
    _run(env, 3)
    profiling.disable()
    rows = budget or 8
    assert profiling.total("reset_rows") - before == 3 * rows
    assert _summed("reset_rows", within="rcw.env.reset") == 3 * rows


def test_episodes_ended_is_the_sum_of_done():
    env = _env(num_envs=8, max_episode_steps=3)
    profiling.enable()
    results = _run(env, 7)
    profiling.disable()
    want = sum(int(r.done.sum()) for r in results)
    assert want > 0
    assert _summed("episodes_ended", within="rcw.env.step") == want


def test_host_copy_bytes_of_an_adapter_step():
    adapter = rt.GymVectorAdapter(rt.SingleRoom(rt.EnvConfig(**SMALL)), 4, device="cpu")
    adapter.reset(seed=4)
    before = profiling.total("host_copy_bytes")
    profiling.enable()
    obs, reward, terminated, truncated, info = adapter.step(np.zeros(4, np.int32))
    profiling.disable()
    want = obs.nbytes + reward.nbytes + sum(v.nbytes for v in info.values())
    assert terminated is info["terminated"] and truncated is info["truncated"]
    assert profiling.total("host_copy_bytes") - before == want
    assert _summed("host_copy_bytes", within="rcw.gym.to_host") == want


def test_kernel_launch_is_spanned_and_counted(monkeypatch):
    """``cuda_build.launch`` with a stand-in entry and stream (no card)."""
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    calls = []

    def rcw_stand_in(*args):
        calls.append(args)
        return len(calls) - 1  # 0 (launched) the first time, an error after

    before = profiling.total("kernel_launches.stand_in")
    profiling.enable()
    with profiling.span("t.caller"):
        cuda_build.launch(rcw_stand_in, "cpu", 1, 2, what="stand-in")
    with pytest.raises(RuntimeError, match="stand-in kernel launch failed"):
        cuda_build.launch(rcw_stand_in, "cpu", 1, 2, what="stand-in")
    profiling.disable()
    assert calls == [(1, 2, 0), (1, 2, 0)]
    assert profiling.total("kernel_launches.stand_in") == before + 1  # a refused one: no
    spans = profiling.spans()
    first = _named(spans, "rcw.kernel.stand_in")[0]
    assert spans[spans[first].parent].name == "t.caller"
    assert _summed("kernel_launches.stand_in", within="t.caller") == 1


@pytest.mark.parametrize("budget", [0, 3])
def test_same_results_with_tracing_on_and_off(budget):
    env = _env(num_envs=8, reset_budget=budget, max_episode_steps=4)
    off = _run(env, 6)
    profiling.enable()
    on = _run(env, 6)
    profiling.disable()
    for a, b in zip(off, on):
        for x, y in zip((a.obs, a.reward, a.done), (b.obs, b.reward, b.done)):
            assert x.dtype == y.dtype and torch.equal(x, y)
        x, y = a.state.to_numpy(), b.state.to_numpy()
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
    adapters = [rt.GymVectorAdapter(env.game, 4, device="cpu") for _ in range(2)]
    for a in adapters:
        a.reset(seed=9)
    got_off = adapters[0].step(np.arange(4, dtype=np.int32) % 4)
    profiling.enable()
    got_on = adapters[1].step(np.arange(4, dtype=np.int32) % 4)
    profiling.disable()
    for x, y in zip(got_off[:4], got_on[:4]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_cuda_kernel_span_inside_the_cast():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    env = _env(num_envs=64, device="cuda")
    state, _ = env.reset(rt.rng.PRNGKey(3))
    before = profiling.total("kernel_launches.crossing_cast")
    profiling.enable()
    env.step(state, _actions(env, 0))
    torch.cuda.synchronize()
    profiling.disable()
    assert profiling.total("kernel_launches.crossing_cast") == before + 1
    spans = profiling.spans()
    (k,) = _named(spans, "rcw.kernel.crossing_cast")
    assert spans[spans[k].parent].name == "rcw.game.cast_batch"


def _random_room_env(num_envs=8, reset_budget=3, device="cpu", **cfg):
    cfg = dict(num_rays=16, height_camera_view_pu=8, obs_type="camera_rgb",
               max_episode_steps=3, **cfg)
    return rt.Env(rt.RandomRoom(rt.RandomRoomConfig(**cfg)), num_envs=num_envs, device=device,
                  reset_budget=reset_budget)


def _ancestors(spans, i):
    names = []
    while spans[i].parent >= 0:
        i = spans[i].parent
        names.append(spans[i].name)
    return names


def test_random_room_fill_and_rgb_spans_under_the_step():
    env = _random_room_env()
    state, _ = env.reset(rt.rng.PRNGKey(3))
    profiling.enable()
    for t in range(4):
        state = env.step(state, _actions(env, t)).state
    profiling.disable()
    spans = profiling.spans()
    fills, rgbs = _named(spans, "rcw.ops.flood_fill"), _named(spans, "rcw.ops.u32_to_rgb")
    assert len(fills) == 4 and len(rgbs) == 4  # one reset and one frame a step
    for i in fills:
        assert _ancestors(spans, i)[:2] == ["rcw.env.reset", "rcw.env.step"]
    for i in rgbs:
        assert _ancestors(spans, i) == ["rcw.ops.render_observation", "rcw.game.observe_batch",
                                        "rcw.env.step"]


@pytest.mark.cuda
def test_cuda_random_room_kernel_spans_inside_their_ops():
    """On the card each step's fill and RGB conversion launch their
    kernels, whose spans sit inside ``rcw.ops.flood_fill`` and
    ``rcw.ops.u32_to_rgb``: the device time the benchmark's
    ``rgb_convert_roofline`` reads is the conversion kernel's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    env = _random_room_env(device="cuda")
    state, _ = env.reset(rt.rng.PRNGKey(3))
    before = profiling.total("kernel_launches.u32_to_rgb")
    profiling.enable()
    for t in range(4):
        state = env.step(state, _actions(env, t)).state
    torch.cuda.synchronize()
    profiling.disable()
    assert profiling.total("kernel_launches.u32_to_rgb") == before + 4
    spans = profiling.spans()
    for op in ("flood_fill", "u32_to_rgb"):
        kernels = _named(spans, f"rcw.kernel.{op}")
        assert len(kernels) == len(_named(spans, f"rcw.ops.{op}")) == 4
        for k in kernels:
            assert spans[spans[k].parent].name == f"rcw.ops.{op}"


@pytest.mark.parametrize("flood_iters,per_fill", [(-1, 16 * 16 // 2 + 2), (5, 5)])
def test_flood_dilations_per_fill(flood_iters, per_fill):
    env = _random_room_env(height_tile_map_tu=16, width_tile_map_tu=16, flood_iters=flood_iters)
    state, _ = env.reset(rt.rng.PRNGKey(4))
    before = profiling.total("flood_dilations")
    profiling.enable()
    for t in range(3):
        state = env.step(state, _actions(env, t)).state
    profiling.disable()
    fills = _named(profiling.spans(), "rcw.ops.flood_fill")
    assert len(fills) == 3
    assert _summed("flood_dilations", within="rcw.ops.flood_fill") == 3 * per_fill
    assert profiling.total("flood_dilations") - before == 3 * per_fill


def test_budget_resets_counts_the_envs_reset():
    """8 envs truncate together at their third step under a budget of 3:
    the budget then resets 3 a step while the others wait."""
    env = _random_room_env()
    state, _ = env.reset(rt.rng.PRNGKey(5))
    profiling.enable()
    reset_now = []
    for t in range(7):
        res = env.step(state, _actions(env, t))
        needy = state.pending_reset | res.done
        reset_now.append(int((needy & ~res.state.pending_reset).sum()))
        state = res.state
    profiling.disable()
    assert sum(reset_now) > 3 and max(reset_now) == 3
    assert _summed("budget_resets", within="rcw.env.reset") == sum(reset_now)
    assert _summed("reset_rows", within="rcw.env.reset") == 7 * 3


def test_random_room_same_results_with_tracing_on_and_off():
    env = _random_room_env()
    off = _run(env, 6)
    profiling.enable()
    on = _run(env, 6)
    profiling.disable()
    assert _named(profiling.spans(), "rcw.ops.flood_fill")
    for a, b in zip(off, on):
        for x, y in zip((a.obs, a.reward, a.done), (b.obs, b.reward, b.done)):
            assert x.dtype == y.dtype and torch.equal(x, y)
        x, y = a.state.to_numpy(), b.state.to_numpy()
        for k in x:
            assert np.array_equal(x[k], y[k]), k


def _maze_env(num_envs=8, reset_budget=3, device="cpu"):
    cfg = rt.MazeConfig(num_rays=16, height_camera_view_pu=8, max_episode_steps=3)
    return rt.Env(rt.Maze(cfg), num_envs=num_envs, device=device, reset_budget=reset_budget)


@pytest.mark.parametrize("budget", [0, 3])
def test_maze_reset_span_counts_its_maps(budget):
    """The first reset generates a maze per env; each step's reset then
    generates ``reset_budget`` under a budget and a maze per env without
    one, inside ``rcw.env.reset``."""
    env = _maze_env(reset_budget=budget)
    before = profiling.total("maze_maps")
    profiling.enable()
    state, _ = env.reset(rt.rng.PRNGKey(6))
    for t in range(4):
        state = env.step(state, _actions(env, t)).state
    profiling.disable()
    spans = profiling.spans()
    resets = _named(spans, "rcw.game.maze_reset")
    assert len(resets) == 5 and spans[resets[0]].parent == -1
    for i in resets[1:]:
        assert _ancestors(spans, i) == ["rcw.env.reset", "rcw.env.step"]
    want = 8 + 4 * (budget or 8)
    assert _summed("maze_maps", within="rcw.game.maze_reset") == want
    assert profiling.total("maze_maps") - before == want


def test_maze_reset_kernel_span_inside_the_reset(monkeypatch):
    """With the reset dispatched as for a CUDA key (an emulation of the
    kernel on host memory, launched through ``cuda_build.launch``), each
    reset's one launch of ``maze_reset`` opens ``rcw.kernel.maze_reset``
    inside ``rcw.game.maze_reset``, and a budgeted step counts one
    ``kernel_launches.maze_reset`` there."""
    monkeypatch.setattr(maze_module, "_uses_kernel", lambda keys: True)
    monkeypatch.setattr(cuda_build, "load", lambda: types.SimpleNamespace(
        rcw_maze_reset=maze_kernel_emulation.rcw_maze_reset))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    env = _maze_env()
    state, _ = env.reset(rt.rng.PRNGKey(6))
    before = profiling.total("kernel_launches.maze_reset")
    profiling.enable()
    state = env.step(state, _actions(env, 0)).state
    profiling.disable()
    assert profiling.total("kernel_launches.maze_reset") == before + 1
    spans = profiling.spans()
    (k,) = _named(spans, "rcw.kernel.maze_reset")
    assert _ancestors(spans, k) == ["rcw.game.maze_reset", "rcw.env.reset", "rcw.env.step"]
    assert _summed("kernel_launches.maze_reset", within="rcw.game.maze_reset") == 1


@pytest.mark.cuda
def test_cuda_maze_reset_threefry_launches_inside_its_span():
    """On the card each reset is one ``maze_reset`` launch inside
    ``rcw.game.maze_reset``, and no threefry launch is left there: the
    kernels the benchmark's ``maze_reset_device_ms`` and
    ``maze_reset_launches`` read."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    env = _maze_env(num_envs=64, reset_budget=16, device="cuda")
    state, _ = env.reset(rt.rng.PRNGKey(3))
    actions = [_actions(env, t) for t in range(3)]
    profiling.enable()
    for a in actions:
        state = env.step(state, a).state
    torch.cuda.synchronize()
    profiling.disable()
    spans = profiling.spans()
    resets = _named(spans, "rcw.game.maze_reset")
    kernels = _named(spans, "rcw.kernel.maze_reset")
    assert len(resets) == len(kernels) == 3
    assert all(spans[k].parent in resets for k in kernels)
    assert _summed("kernel_launches.maze_reset", within="rcw.game.maze_reset") == 3
    assert not [k for k in _named(spans, "rcw.kernel.threefry")
                if "rcw.game.maze_reset" in _ancestors(spans, k)]
    assert _summed("kernel_launches.threefry", within="rcw.game.maze_reset") == 0


def _multi_player_env(num_envs=6, device="cpu", **cfg):
    cfg = dict(num_rays=16, height_camera_view_pu=8, **cfg)
    return rt.Env(rt.MultiPlayerRoom(rt.MultiPlayerConfig(**cfg)), num_envs=num_envs,
                  device=device)


@pytest.mark.parametrize("players", [2, 3])
def test_player_spans_open_once_an_observation(players):
    """The reset's observation and each step's: one ``rcw.game.cast_players``
    counting B*P ``player_views``, and one ``rcw.ops.sprite_overlay``, each
    inside the step's observation."""
    env = _multi_player_env(num_players=players)
    before = profiling.total("player_views")
    profiling.enable()
    state, _ = env.reset(rt.rng.PRNGKey(6))
    for t in range(3):
        state = env.step(state, _actions(env, t)).state
    profiling.disable()
    spans = profiling.spans()
    for name in ("rcw.game.cast_players", "rcw.ops.sprite_overlay"):
        found = _named(spans, name)
        assert len(found) == 4
        assert _ancestors(spans, found[0]) == []
        for i in found[1:]:
            assert _ancestors(spans, i) == ["rcw.game.observe_batch", "rcw.env.step"]
    assert _summed("player_views", within="rcw.game.cast_players") == 4 * 6 * players
    assert profiling.total("player_views") - before == 4 * 6 * players


def test_no_sprite_span_where_players_are_unseen():
    env = _multi_player_env(players_visible=False)
    profiling.enable()
    state, _ = env.reset(rt.rng.PRNGKey(6))
    env.step(state, _actions(env, 0))
    profiling.disable()
    spans = profiling.spans()
    assert len(_named(spans, "rcw.game.cast_players")) == 2
    assert not _named(spans, "rcw.ops.sprite_overlay")


def _cell_env():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs", "multi_player_2p.json")) as f:
        return json.load(f)["env"]


@pytest.mark.cuda
def test_cuda_multi_player_cell_equals_the_cpu():
    """The benchmark cell's configuration at 4096 envs, 12 steps: the card's
    states and frames equal the CPU's, and each observation's cast is one
    ``crossing_cast`` launch inside ``rcw.game.cast_players``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = rt.MultiPlayerConfig(**_cell_env())
    gen = torch.Generator().manual_seed(12)
    actions = torch.randint(0, 4, (12, 4096, 2), generator=gen, dtype=torch.int32)
    runs = {}
    for device in ("cpu", "cuda"):
        env = rt.Env(rt.MultiPlayerRoom(cfg), num_envs=4096, device=device)
        state, obs = env.reset(rt.rng.PRNGKey(7).to(device))
        frames = [obs.view(torch.int32).cpu()]
        if device == "cuda":
            profiling.enable()
        for a in actions:
            res = env.step(state, a.to(device))
            state = res.state
            frames.append(res.obs.view(torch.int32).cpu())
        if device == "cuda":
            torch.cuda.synchronize()
            profiling.disable()
        runs[device] = state.to_numpy(), torch.stack(frames)
    (cpu_state, cpu_frames), (card_state, card_frames) = runs["cpu"], runs["cuda"]
    for leaf in cpu_state:
        assert np.array_equal(cpu_state[leaf], card_state[leaf]), leaf
    assert torch.equal(cpu_frames, card_frames)
    assert int((cpu_frames == 0x0000FF).sum()) > 0      # sprites shown
    spans = profiling.spans()
    casts = _named(spans, "rcw.game.cast_players")
    kernels = _named(spans, "rcw.kernel.crossing_cast")
    assert len(casts) == len(kernels) == 12
    assert all(spans[k].parent in casts for k in kernels)
    assert _summed("kernel_launches.crossing_cast", within="rcw.game.cast_players") == 12
