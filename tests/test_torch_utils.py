"""The port's tools against the JAX package's: debug checks, profiling
helpers, episode video, the frame writers and viewers, and the web play
session.  Exact everywhere but ``device_metrics``' float sums, held to 1e-6
relative (XLA and torch reduce in different orders)."""

import io
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu.utils import debug as jdebug
from raycastworlds_tpu.utils import profiling as jprofiling
from raycastworlds_tpu.utils import video as jvideo
from raycastworlds_tpu.utils import viewer as jviewer
from raycastworlds_tpu.utils import webviewer as jwebviewer
from raycastworlds_tpu_torch.state import LEAVES
from raycastworlds_tpu_torch.utils import debug, profiling, to_numpy, video, viewer, webviewer

SMALL = dict(num_rays=16, height_camera_view_pu=16)


def _env(num_envs=2, **kw):
    return rt.Env(rt.SingleRoom(rt.EnvConfig(**SMALL, **kw)), num_envs=num_envs,
                  device="cpu")


def _jenv(num_envs=2, **kw):
    return rcw.Env(rcw.SingleRoom(rcw.EnvConfig(**SMALL, **kw)), num_envs=num_envs)


# -- debug -------------------------------------------------------------------


def test_validate_state_matches_jax():
    """Clean, and the bad state of tests/test_debug.py: both packages pass
    and raise alike."""
    cfg = rt.EnvConfig(**SMALL)
    jenv = _jenv(4)
    js, _ = jenv.reset(jax.random.PRNGKey(0))
    ts = rt.EnvState.from_numpy({k: np.asarray(getattr(js, k)) for k in LEAVES}).replace(
        hw=js.hw)
    jdebug.validate_state(jenv.cfg, js)
    debug.validate_state(cfg, ts)
    bad = js.replace(pos_wu=js.pos_wu.at[0].set(jnp.array([-1.0, 2.0])))
    with pytest.raises(AssertionError):
        jdebug.validate_state(jenv.cfg, bad)
    pos = ts.pos_wu.clone()
    pos[0] = torch.tensor([-1.0, 2.0])
    with pytest.raises(AssertionError, match="outside the map"):
        debug.validate_state(cfg, ts.replace(pos_wu=pos))
    walls = ts.wall_map.clone()
    walls[1, ts.goal_tu[1, 0], ts.goal_tu[1, 1]] = True
    with pytest.raises(AssertionError, match="goal inside a wall"):
        debug.validate_state(cfg, ts.replace_walls(walls))


def test_checked_step():
    env = _env(4)
    state, _ = env.reset(rt.rng.PRNGKey(0))
    err, res = debug.checked(env.step)(state, torch.zeros(4, dtype=torch.int32))
    assert err.get() is None
    err.throw()
    assert isinstance(res, rt.StepResult)
    # a NaN position and a goal off the map are caught in the outputs
    pos = res.state.pos_wu.clone()
    pos[2, 0] = float("nan")
    err, _ = debug.checked(lambda s: s.replace(pos_wu=pos))(res.state)
    assert "pos_wu: 1 non-finite" in err.get()
    with pytest.raises(RuntimeError, match="non-finite"):
        err.throw()
    goal = res.state.goal_tu.clone()
    goal[1] = torch.tensor([100, 3])
    err, out = debug.checked(lambda s: (s.replace(goal_tu=goal), {"r": res.reward}))(
        res.state)
    assert "goal_tu: 1 tiles outside" in err.get()
    assert torch.equal(out[1]["r"], res.reward)


# -- profiling ---------------------------------------------------------------


@pytest.mark.parametrize("p_done", [0.0, 0.05, 0.3])
def test_device_metrics_matches_jax(p_done):
    g = np.random.default_rng(int(p_done * 100))
    done = g.random((32, 64)) < p_done
    reward = np.where(done & (g.random((32, 64)) < 0.6), 1.0, 0.0).astype(np.float32)
    reward += g.normal(size=reward.shape).astype(np.float32) * np.float32(0.01)
    want = {k: np.asarray(v) for k, v in
            jprofiling.device_metrics(jnp.asarray(done), jnp.asarray(reward)).items()}
    got = {k: v.numpy() for k, v in
           profiling.device_metrics(torch.from_numpy(done), torch.from_numpy(reward)).items()}
    assert sorted(got) == sorted(want)
    for k in ("env_steps", "episodes"):
        assert got[k].dtype == want[k].dtype == np.int32
        assert got[k] == want[k], k
    for k in ("return_sum", "success_rate"):
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_meter():
    m = profiling.Meter()
    for eps, ret in ((3, 2.0), (1, 1.0)):
        m.update({"env_steps": torch.tensor(100, dtype=torch.int32),
                  "episodes": torch.tensor(eps, dtype=torch.int32),
                  "return_sum": torch.tensor(ret)})
    snap = m.snapshot()
    assert snap["env_steps"] == 200.0 and snap["episodes"] == 4.0
    assert snap["mean_return"] == 0.75 and snap["steps_per_sec"] > 0
    assert profiling.Meter().snapshot()["mean_return"] == 0.0


def test_trace_and_aggregate(tmp_path):
    x = torch.ones(64, 64)

    @profiling.annotate("labelled")
    def inner(y):
        return (y @ y).sum()

    with profiling.trace(str(tmp_path)):
        inner(x)
        (x + x).sum()
    assert os.path.exists(tmp_path / profiling.TRACE_FILE)
    us, calls, within = profiling.aggregate_trace(str(tmp_path), "cpu_op",
                                                  within=["labelled", "missing"])
    assert calls["aten::add"] >= 1 and calls["aten::mm"] >= 1
    assert us["aten::mm"] > 0
    # the matmul ran inside the label, the add outside it
    assert us["aten::mm"] <= within["labelled"] < sum(us.values())
    assert within["missing"] == 0
    # no CUDA kernel on the CPU
    assert profiling.aggregate_trace(str(tmp_path / profiling.TRACE_FILE))[1] == {}


# -- video -------------------------------------------------------------------


@pytest.mark.parametrize("view", ["camera", "top"])
def test_record_episode_matches_jax(view):
    kw = dict(pu_per_tu=4) if view == "top" else {}
    want = jvideo.record_episode(_jenv(2, **kw), jax.random.PRNGKey(1), steps=6, view=view,
                                 env_index=1)
    got = video.record_episode(_env(2, **kw), rt.rng.PRNGKey(1), steps=6, view=view,
                               env_index=1)
    assert got.dtype == want.dtype == np.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert any(not np.array_equal(got[i], got[i + 1]) for i in range(6))


def test_record_episode_multi_player_matches_jax():
    kw = dict(num_players=2, **SMALL)
    want = jvideo.record_episode(
        rcw.Env(rcw.MultiPlayerRoom(rcw.MultiPlayerConfig(**kw)), num_envs=1),
        jax.random.PRNGKey(0), steps=3)
    got = video.record_episode(
        rt.Env(rt.MultiPlayerRoom(rt.MultiPlayerConfig(**kw)), num_envs=1, device="cpu"),
        rt.rng.PRNGKey(0), steps=3)
    assert got.shape == want.shape == (4, 2, 16, 16)
    np.testing.assert_array_equal(got, want)


def test_record_episode_with_policy():
    calls = []

    def policy(key, obs):
        calls.append(key)
        return torch.full((obs.shape[0],), 2, dtype=torch.int32)

    frames = video.record_episode(_env(2), rt.rng.PRNGKey(3), steps=3, policy=policy)
    assert frames.shape == (4, 16, 16) and len(calls) == 3


def test_fallback_gif_matches_jax(tmp_path):
    """The dependency-free writer's bytes equal the JAX module's, for
    paletted episode frames and for > 256 colours (the 3-3-2 quantization)."""
    frames = video.record_episode(_env(2), rt.rng.PRNGKey(2), steps=3)
    noisy = np.random.default_rng(0).integers(0, 256, size=(2, 20, 24, 3)).astype(np.uint8)
    for name, f in (("episode", frames), ("noisy", noisy)):
        ours, theirs = tmp_path / f"{name}_port.gif", tmp_path / f"{name}_jax.gif"
        video._write_gif_fallback(str(ours), video._to_rgb(f), duration_ms=50)
        jvideo._write_gif_fallback(str(theirs), jvideo._to_rgb(f), duration_ms=50)
        assert ours.read_bytes() == theirs.read_bytes(), name
    from PIL import Image

    im = Image.open(tmp_path / "episode_port.gif")
    assert im.n_frames == 4
    for t in range(4):
        im.seek(t)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), video._to_rgb(frames)[t])


def test_save_gif_pillow_roundtrip(tmp_path):
    frames = video.record_episode(_env(2), rt.rng.PRNGKey(1), steps=4)
    path = str(tmp_path / "ep.gif")
    assert video.save_gif(path, torch.from_numpy(frames.view(np.int32)).view(torch.uint32),
                          fps=10, scale=2) == path
    from PIL import Image

    im = Image.open(path)
    assert im.size == (32, 32) and im.n_frames == 5


def test_gif_rejects_bad_shapes(tmp_path):
    with pytest.raises(ValueError):
        video.save_gif(str(tmp_path / "x.gif"), np.zeros((4, 4)))


# -- viewer ------------------------------------------------------------------


@pytest.fixture
def frame():
    img = np.random.default_rng(0).integers(0, 2**24, size=(10, 12)).astype(np.uint32)
    img[:4] = 0x00FF0000
    return img


@pytest.fixture(params=["native", "fallback"])
def lib(request, monkeypatch):
    """Both modules with their native library, or both on the NumPy
    fallback (no library)."""
    if request.param == "native":
        if viewer._native_lib() is None or jviewer._native_lib() is None:
            pytest.fail("native/libviewer.so did not build")
    else:
        for mod in (viewer, jviewer):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_LIB_TRIED", True)
    return request.param


def test_writers_match_jax(tmp_path, frame, lib):
    ours, theirs = tmp_path / "port.ppm", tmp_path / "jax.ppm"
    viewer.save_ppm(str(ours), frame)
    jviewer.save_ppm(str(theirs), frame)
    assert ours.read_bytes() == theirs.read_bytes()
    assert viewer.png_bytes(frame) == jviewer.png_bytes(frame)
    viewer.save_png(str(tmp_path / "port.png"), torch.from_numpy(frame.view(np.int32)))
    assert (tmp_path / "port.png").read_bytes() == jviewer.png_bytes(frame)
    for width in (160, 5):
        assert viewer.ansi_frame(frame, max_width=width) == jviewer.ansi_frame(
            frame, max_width=width)


def test_play_headless_matches_jax():
    """Headless play() (no TTY, no window) renders the reset frame once,
    as the JAX module does."""
    ours, theirs = io.StringIO(), io.StringIO()
    viewer.play(seed=0, max_width=32, out=ours, window=False, device="cpu")
    jviewer.play(seed=0, max_width=32, out=theirs, window=False)
    assert "steps=0" in ours.getvalue() and "▀" in ours.getvalue()
    assert ours.getvalue() == theirs.getvalue()


def test_window_degrades_headless(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    assert viewer.Window.available() is False
    assert viewer.Window.open("t", 16, 16) is None
    out = io.StringIO()
    viewer.play(seed=1, max_width=32, out=out, window=None, device="cpu")
    assert "steps=0" in out.getvalue()


# -- webviewer ---------------------------------------------------------------


def test_web_session_matches_jax():
    cfg = dict(num_rays=32, height_camera_view_pu=32)
    jenv = rcw.Env(rcw.SingleRoom(rcw.EnvConfig(**cfg)), num_envs=1)
    env = rt.Env(rt.SingleRoom(rt.EnvConfig(**cfg)), num_envs=1, device="cpu")
    js, ts = jwebviewer.WebPlaySession(jenv, seed=3), webviewer.WebPlaySession(env, seed=3)
    assert ts.frame_png() == js.frame_png()
    assert ts.status() == js.status()
    for ch in "wwawdsvrw":
        assert ts.handle_key(ch) == js.handle_key(ch)
        assert ts.frame_png() == js.frame_png()
        assert ts.status() == js.status()
    assert ts.handle_key("x")["ok"] is False
    assert ts.handle_key("q")["quit"] is True


def test_web_session_rejects_multi_player():
    env = rt.Env(rt.MultiPlayerRoom(rt.MultiPlayerConfig(num_players=2, **SMALL)),
                 num_envs=1, device="cpu")
    with pytest.raises(ValueError, match="single-agent"):
        webviewer.WebPlaySession(env)


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def test_webviewer_http_smoke():
    viewer_ = webviewer.WebViewer(seed=3, host="127.0.0.1", port=0, device="cpu").start()
    base = f"http://127.0.0.1:{viewer_.port}"
    try:
        assert b"raycastworlds_tpu_torch" in _get(base + "/")
        frame0 = _get(base + "/frame.png")
        assert frame0[:8] == b"\x89PNG\r\n\x1a\n"
        assert json.loads(_get(base + "/status"))["view"] == "camera"
        out = json.loads(_get(base + "/key?k=w"))
        assert out["ok"] and out["steps"] == 1
        assert json.loads(_get(base + "/key?k=v"))["view"] == "top"
        assert _get(base + "/frame.png") != frame0
        assert json.loads(_get(base + "/key?k=r"))["steps"] == 0
        assert json.loads(_get(base + "/key?k=q"))["quit"]
        with pytest.raises(urllib.error.HTTPError):
            _get(base + "/nowhere")
    finally:
        viewer_.stop()
    assert to_numpy(torch.zeros(2, dtype=torch.uint32)).dtype == np.uint32
