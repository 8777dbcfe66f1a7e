"""The port's FrameStack, ObsTransform and downsample2x against the JAX
package's, exact: stacked frames through shifts and episode restarts, and
the 2x mean pool of u32 [B, H, W] and rgb [B, H, W, 3] observations
(float32 sums in the JAX order, so no ulp is allowed).  The stacks hold
gray_u8 and u32 frames: the jitted JAX camera_gray is a few ulp off the
port through XLA's FMA contraction (ROADMAP, port ground rules)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu.wrappers import downsample2x as jdown
from raycastworlds_tpu_torch.state import LEAVES
from raycastworlds_tpu_torch.wrappers import downsample2x

B = 6
SMALL = dict(num_rays=16, height_camera_view_pu=16, max_episode_steps=4)


def _envs(obs_type, **kw):
    cfg = dict(SMALL, obs_type=obs_type, **kw)
    return (rcw.Env(rcw.SingleRoom(rcw.EnvConfig(**cfg)), num_envs=B, jit=False),
            rt.Env(rt.SingleRoom(rt.EnvConfig(**cfg)), num_envs=B, device="cpu"))


def _np(x):
    return rt.utils.to_numpy(x)


def _assert_state_equal(got, want):
    g = got.to_numpy()
    for k in LEAVES:
        np.testing.assert_array_equal(g[k], np.asarray(getattr(want, k)), err_msg=k)


@pytest.mark.parametrize("obs_type", ["camera_gray_u8", "camera_u32"])
def test_frame_stack_matches_jax(obs_type):
    jenv, env = _envs(obs_type)
    jfs, tfs = rcw.FrameStack(jenv, n_stack=3), rt.FrameStack(env, n_stack=3)
    assert tfs.observation_space.shape == jfs.observation_space.shape == (3, 16, 16)
    assert tfs.action_space.n == 4
    js, jobs = jfs.reset(jax.random.PRNGKey(2))
    ts, tobs = tfs.reset(rt.rng.PRNGKey(2))
    assert tobs.dtype == env.observation_space.dtype
    np.testing.assert_array_equal(_np(tobs), np.asarray(jobs))
    prev = _np(tobs)
    restarts = 0
    for a in np.random.default_rng(2).integers(0, 4, size=(9, B)).astype(np.int32):
        jr = jfs.step(js, jnp.asarray(a))
        tr = tfs.step(ts, torch.from_numpy(a))
        got = _np(tr.obs)
        np.testing.assert_array_equal(got, np.asarray(jr.obs))
        np.testing.assert_array_equal(_np(tr.state.frames), got)
        _assert_state_equal(tr.state.env_state, jr.state.env_state)
        np.testing.assert_array_equal(_np(tr.reward), np.asarray(jr.reward))
        np.testing.assert_array_equal(_np(tr.done), np.asarray(jr.done))
        done = _np(tr.done)
        # the newest frame is last; the older ones shift, or restart on done
        np.testing.assert_array_equal(got[~done, :2], prev[~done, 1:])
        for k in range(3):
            np.testing.assert_array_equal(got[done, k], got[done, 2])
        restarts += int(done.sum())
        js, ts, prev = jr.state, tr.state, got
    assert restarts > 0


def test_frame_stack_rejects_empty_stack():
    _, env = _envs("camera_gray_u8")
    with pytest.raises(ValueError, match="n_stack"):
        rt.FrameStack(env, n_stack=0)


@pytest.mark.parametrize("obs_type", ["camera_u32", "camera_rgb", "camera_gray_u8"])
def test_obs_transform_downsample_matches_jax(obs_type):
    jenv, env = _envs(obs_type)
    jw = rcw.ObsTransform(jenv, jdown)
    tw = rt.ObsTransform(env, downsample2x)
    assert tw.action_space.n == 4
    js, jobs = jw.reset(jax.random.PRNGKey(4))
    ts, tobs = tw.reset(rt.rng.PRNGKey(4))
    assert tobs.dtype == torch.float32
    np.testing.assert_array_equal(_np(tobs), np.asarray(jobs))
    for a in np.random.default_rng(4).integers(0, 4, size=(5, B)).astype(np.int32):
        jr = jw.step(js, jnp.asarray(a))
        tr = tw.step(ts, torch.from_numpy(a))
        assert tr.obs.shape == jr.obs.shape
        np.testing.assert_array_equal(_np(tr.obs), np.asarray(jr.obs))
        np.testing.assert_array_equal(_np(tr.done), np.asarray(jr.done))
        js, ts = jr.state, tr.state


@pytest.mark.parametrize("shape,dtype", [((5, 8, 6), np.uint32), ((3, 6, 4, 3), np.uint8),
                                         ((2, 4, 8), np.float32)])
def test_downsample2x_matches_jax(shape, dtype):
    g = np.random.default_rng(0)
    if dtype == np.uint32:
        x = g.integers(0, 2**24, size=shape).astype(np.uint32)
        t = torch.from_numpy(x.view(np.int32)).view(torch.uint32)
    elif dtype == np.uint8:
        x = g.integers(0, 256, size=shape).astype(np.uint8)
        t = torch.from_numpy(x)
    else:
        x = g.normal(size=shape).astype(np.float32)
        t = torch.from_numpy(x)
    np.testing.assert_array_equal(downsample2x(t).numpy(), np.asarray(jdown(jnp.asarray(x))))
    with pytest.raises(ValueError, match="ndim"):
        downsample2x(torch.zeros(4, 4))
