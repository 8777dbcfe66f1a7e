"""The fused crossing cast + pal8 render (``ops/raycast_crossing_kernel.
cast_render_pal8_kernel``) and the ``crossing_kernel_fused`` backend vs the
JAX package.

* The kernel's wrapper on CPU tensors runs its plain version and launches
  nothing; it is held against the JAX package's Pallas kernel in interpret
  mode on fans with no exact-zero component, and against the plain pal8
  render of the plain crossing cast on every input (exact).
* ``Game.observe_batch`` of ``crossing_kernel_fused`` in every observation
  form against the JAX package with the same config, and a 20-step Env
  rollout in camera_pal8 against the JAX ``crossing`` env, frame by frame.
* On a CUDA card, the CUDA kernel against its plain version:
  ``python -m pytest tests/test_torch_pal8_kernel.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch.ops import raycast, render
from raycastworlds_tpu_torch.ops import raycast_crossing_kernel as rck
from raycastworlds_tpu_torch.utils import profiling
from test_torch_fused_render import (
    OBS, assert_obs_equal, assert_rollouts_equal, observe_both, render_case, t,
)

CASES = [
    dict(num_rays=64, height_camera_view_pu=24),
    dict(height_tile_map_tu=13, width_tile_map_tu=9, num_directions=96,
         num_rays=32, height_camera_view_pu=17, semi_field_of_view_wu=0.5),
    dict(height_tile_map_tu=24, width_tile_map_tu=40, num_rays=64,
         height_camera_view_pu=20),
]
IDS = ["default_small", "odd", "wide_map"]


def _args(c, device="cpu"):
    cfg = c["cfg"]
    d = lambda a: t(a).to(device)  # noqa: E731
    return (d(c["obstacle"]), (cfg.H, cfg.W), d(c["pos"]), d(c["dirs"]),
            d(c["pdir"]), d(c["goal"]), cfg.height_camera_view_pu, c["num"],
            c["denom"])


def _single_goal_case(kw, b, seed, kind="random"):
    """render_case without block tiles: the obstacles are walls | goal."""
    c = render_case(kw, b, seed, kind)
    c["obstacle"] = c["wall"].copy()
    w = c["cfg"].W
    for e, (i, j) in enumerate(c["goal"]):
        k = int(i) * w + int(j)
        c["obstacle"][e, k // 32] |= np.uint32(1) << np.uint32(k % 32)
    return c


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_wrapper_cpu_matches_pallas_interpret(kw):
    import jax.numpy as jnp
    from raycastworlds_tpu.ops import raycast_crossing_kernel as jrck

    c = _single_goal_case(kw, 8, seed=40)
    assert (c["dirs"] != 0).all()
    cfg = c["cfg"]
    want = jrck.cast_render_pal8_kernel(
        jnp.asarray(c["obstacle"]), (cfg.H, cfg.W), jnp.asarray(c["pos"]),
        jnp.asarray(c["dirs"]), jnp.asarray(c["pdir"]), jnp.asarray(c["goal"]),
        cfg.height_camera_view_pu, c["num"], c["denom"], interpret=True,
    )
    before = profiling.total("kernel_launches.crossing_render_pal8")
    got = rck.cast_render_pal8_kernel(*_args(c))
    assert profiling.total("kernel_launches.crossing_render_pal8") == before  # CPU: no launch
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["random", "sliding"])
@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_plain_version_is_the_pal8_render(kw, kind):
    """Goal-vs-wall by tile equality on the mirror-ordered fan equals the
    plain pal8 render (wall-bit lookup, columns mirrored) of the plain
    crossing cast, exact-zero rays included."""
    c = _single_goal_case(kw, 6, seed=41, kind=kind)
    cfg = c["cfg"]
    dirs = torch.flip(t(c["dirs"]), dims=(1,))
    hit_tu, hit_dim, dist = raycast.cast_rays_crossing(
        t(c["obstacle"]), (cfg.H, cfg.W), t(c["pos"]), dirs)
    hits = raycast.RayHits(ray_dirs=dirs, hit_tu=hit_tu, hit_dim=hit_dim, dist_wu=dist)
    want = render.render_camera_pal8(cfg, t(c["wall"]), t(c["pdir"]), hits)
    assert torch.equal(rck.cast_render_pal8_kernel_ref(*_args(c)), want)


@pytest.mark.parametrize("obs_type", OBS)
def test_observe_batch_matches_jax(obs_type):
    kw = dict(num_rays=32, height_camera_view_pu=16,
              raycast_backend="crossing_kernel_fused", obs_type=obs_type)
    got, want = observe_both(kw)
    assert_obs_equal(obs_type, got, want)


def test_env_rollout_matches_jax_crossing():
    kw = dict(num_rays=32, height_camera_view_pu=16, max_episode_steps=8,
              obs_type="camera_pal8")
    assert_rollouts_equal(dict(kw, raycast_backend="crossing_kernel_fused"),
                          dict(kw, raycast_backend="crossing"))


def test_wrapper_rejects_bad_inputs():
    c = _single_goal_case(CASES[0], 2, seed=42)
    args = list(_args(c))
    for k, bad, err in ((5, args[5].long(), TypeError), (4, args[4][:1], ValueError),
                        (6, 0, ValueError), (1, (9, 16), ValueError)):
        with pytest.raises(err):
            rck.cast_render_pal8_kernel(*(args[:k] + [bad] + args[k + 1:]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "sliding", "no_border", "tiny", "corners"])
@pytest.mark.parametrize(
    "kw",
    [dict(num_rays=512), dict(height_tile_map_tu=48, width_tile_map_tu=48,
                              num_rays=129, height_camera_view_pu=100),
     dict(height_tile_map_tu=16, width_tile_map_tu=16, num_rays=256,
          height_camera_view_pu=128),
     dict(num_rays=64, height_camera_view_pu=64),
     dict(height_tile_map_tu=13, width_tile_map_tu=9, num_rays=513),
     dict(height_tile_map_tu=24, width_tile_map_tu=40, num_rays=333,
          height_camera_view_pu=100)],
    ids=["default", "big_map", "room", "small", "odd_map", "wide_map"],
)
def test_cuda_kernel_matches_plain(cuda_device, kw, kind):
    c = _single_goal_case(kw, 16, seed=43, kind=kind)
    args = _args(c, cuda_device)
    before = profiling.total("kernel_launches.crossing_render_pal8")
    got = rck.cast_render_pal8_kernel(*args)
    torch.cuda.synchronize()
    assert profiling.total("kernel_launches.crossing_render_pal8") == before + 1
    assert torch.equal(got, rck.cast_render_pal8_kernel_ref(*args))


def test_single_goal_rule_in_observe_batch():
    """The fused pal8 path is taken only for flat-shaded float32 pal8; other
    observations cast through the split crossing kernel."""
    pal8 = rt.SingleRoom(rt.EnvConfig(raycast_backend="crossing_kernel_fused",
                                      obs_type="camera_pal8", num_rays=8,
                                      height_camera_view_pu=8))
    u32 = rt.SingleRoom(rt.EnvConfig(raycast_backend="crossing_kernel_fused",
                                     num_rays=8, height_camera_view_pu=8))
    state = pal8.reset_batch(rt.rng.split(rt.rng.PRNGKey(0), 4))
    assert pal8._use_kernel_pal8(state) and not u32._use_kernel_pal8(state)
    assert pal8.observe_batch(state).dtype == torch.uint8
