"""The port's EnvConfig: same validation and array-equal host LUTs."""

import dataclasses

import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt

BAD = [
    dict(height_tile_map_tu=2),
    dict(width_tile_map_tu=2),
    dict(player_radius_wu=0.5),
    dict(player_radius_wu=0.0),
    dict(num_rays=1),
    dict(num_directions=0),
    dict(obs_type="camera_bgr"),
    dict(obs_type="camera_pal8", wall_texture="xor", texture_cells=41),
    dict(raycast_backend="warp"),
    dict(wall_texture="marble"),
    dict(dtype="float16"),
    dict(texture_cells=1),
    dict(continuous_heading=True, raycast_backend="crossing_kernel"),
    dict(turn_increment_au=0.0),
]


@pytest.mark.parametrize("kw", BAD, ids=[str(k) for k in BAD])
def test_same_value_errors(kw):
    with pytest.raises(ValueError) as want:
        rcw.EnvConfig(**kw)
    with pytest.raises(ValueError) as got:
        rt.EnvConfig(**kw)
    assert str(got.value) == str(want.value)


def test_fields_match():
    names = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]  # noqa: E731
    assert names(rt.EnvConfig) == names(rcw.EnvConfig)


CONFIGS = [
    dict(),
    dict(num_rays=64, height_camera_view_pu=48),
    dict(height_tile_map_tu=13, width_tile_map_tu=9, num_directions=96,
         num_rays=37, semi_field_of_view_wu=0.5),
    dict(height_tile_map_tu=48, width_tile_map_tu=48, num_rays=128),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=[str(k) for k in CONFIGS])
@pytest.mark.parametrize(
    "lut",
    ["directions_wu", "ray_fan_lut", "ray_fan_lut_flipped", "palette_np",
     "border_wall_words"],
)
def test_luts_array_equal(kw, lut):
    want = getattr(rcw.EnvConfig(**kw), lut)
    got = getattr(rt.EnvConfig(**kw), lut)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_derived_shapes_match():
    for obs in ("camera_u32", "camera_rgb", "camera_pal8", "depth", "top_u32"):
        a = rcw.EnvConfig(obs_type=obs, num_rays=32)
        b = rt.EnvConfig(obs_type=obs, num_rays=32)
        assert a.obs_shape == b.obs_shape
        assert a.dda_steps == b.dda_steps
        assert a.player_radius_pu == b.player_radius_pu


def test_auto_backend_is_device_aware():
    cfg = rt.EnvConfig()
    assert cfg.resolved_raycast_backend("cpu") == "crossing"
    assert cfg.resolved_raycast_backend("cuda") == "crossing_kernel"
    # every float32 discrete-heading shape, small fans and big maps included
    for kw in (dict(num_rays=16),
               dict(height_tile_map_tu=64, width_tile_map_tu=64)):
        assert rt.EnvConfig(**kw).resolved_raycast_backend("cuda") == "crossing_kernel"
    for kw in (dict(dtype="float64"), dict(continuous_heading=True)):
        assert rt.EnvConfig(**kw).resolved_raycast_backend("cuda") == "crossing"
    explicit = rt.EnvConfig(raycast_backend="crossing")
    assert explicit.resolved_raycast_backend("cuda") == "crossing"


def test_auto_keeps_large_maps_off_the_kernel():
    """On the card ``auto`` takes the crossing kernel only for maps whose
    packed words fit its shared memory (KERNEL_MAX_WORDS, the kernel's
    kSmemWords); a 640x640 map (12,800 words) takes the plain crossing
    cast, and an explicit kernel backend is left as asked."""
    big = dict(height_tile_map_tu=640, width_tile_map_tu=640)
    assert rt.EnvConfig(**big).resolved_raycast_backend("cuda") == "crossing"
    assert rcw.EnvConfig(**big).resolved_raycast_backend == "crossing"
    from raycastworlds_tpu_torch.config import KERNEL_MAX_WORDS

    assert KERNEL_MAX_WORDS == 12288
    assert -(-640 * 640 // 32) == 12800 > KERNEL_MAX_WORDS
    # the largest square map whose words fit still takes the kernel
    fits = dict(height_tile_map_tu=627, width_tile_map_tu=627)
    assert -(-627 * 627 // 32) <= KERNEL_MAX_WORDS
    assert rt.EnvConfig(**fits).resolved_raycast_backend("cuda") == "crossing_kernel"
    assert rt.EnvConfig().resolved_raycast_backend("cuda") == "crossing_kernel"
    for backend in ("crossing_kernel", "crossing_kernel_fused", "pallas", "fused"):
        cfg = rt.EnvConfig(**big, raycast_backend=backend)
        assert cfg.resolved_raycast_backend("cuda") == backend


@pytest.mark.parametrize(
    "kw",
    [dict(wall_texture="checker"), dict(dtype="float64"),
     dict(continuous_heading=True)],
)
def test_unported_options_raise(kw):
    """The options of the last slices (textures, float64 worlds, continuous
    headings) construct in the port and a 2-env CPU Env resets and steps
    with them, in the dtypes of the JAX package's state."""
    cfg = rt.EnvConfig(num_rays=8, height_camera_view_pu=8, **kw)
    assert cfg.resolved_raycast_backend("cpu") == "crossing"
    env = rt.Env(rt.SingleRoom(cfg), num_envs=2, device="cpu")
    state, obs = env.reset(rt.rng.PRNGKey(0))
    res = env.step(state, torch.tensor([2, 0], dtype=torch.int32))
    assert res.obs.shape == (2, 8, 8) and res.obs.dtype == torch.uint32
    f = torch.float64 if kw.get("dtype") == "float64" else torch.float32
    h = torch.float32 if kw.get("continuous_heading") else torch.int32
    assert res.state.pos_wu.dtype == f and res.state.dir_au.dtype == h
    assert res.reward.dtype == f
    assert bool(torch.isfinite(res.state.pos_wu).all())


@pytest.mark.parametrize(
    "backend", ["scan", "scan_flat", "pallas", "fused", "crossing_kernel_fused"]
)
def test_dda_and_fused_backends_construct(backend):
    game = rt.SingleRoom(rt.EnvConfig(raycast_backend=backend))
    assert game.cfg.resolved_raycast_backend("cuda") == backend
    assert game.cfg.resolved_raycast_backend("cpu") == backend
