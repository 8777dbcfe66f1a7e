"""The port's last public helpers against the JAX package's: ``config.replace``
and the tile-map and hit-face constants, ``colors.PALETTE_RGB_F32`` and
``rgb_to_u32``, ``collision.is_player_colliding`` (the hand-computed cases
of tests/test_collision.py), ``raycast_analytic.cast_rays_analytic`` (to
the analytic backend's contract, as tests/test_torch_analytic.py holds it)
and ``raycast_pallas.cast_rays_pallas`` (exact, the JAX kernel in
interpret mode; 64 rays, so no ray has an exact-zero component)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu import colors as jcolors
from raycastworlds_tpu import config as jconfig
from raycastworlds_tpu.ops import collision as jcollision
from raycastworlds_tpu.ops import raycast_analytic as janalytic
from raycastworlds_tpu.ops import raycast_pallas as jpallas
from raycastworlds_tpu_torch import colors, config
from raycastworlds_tpu_torch.ops import (
    bitmap, collision, raycast, raycast_analytic, raycast_pallas)


@pytest.mark.parametrize("name", ["NUM_OBJECTS", "WALL", "GOAL", "HIT_DIM_I", "HIT_DIM_J"])
def test_constants(name):
    assert getattr(config, name) == getattr(jconfig, name)


@pytest.mark.parametrize("cls,kw", [
    ("EnvConfig", dict(num_rays=16, raycast_backend="scan")),
    ("RandomRoomConfig", dict(wall_density=0.3, height_tile_map_tu=9)),
    ("MultiPlayerConfig", dict(num_players=3, player_render="block")),
])
def test_config_replace(cls, kw):
    """replace keeps the config class, changes the fields, validates again."""
    base = getattr(rt, cls)()
    got = config.replace(base, **kw)
    want = jconfig.replace(getattr(rcw, cls)(), **kw)
    assert type(got) is type(base) and type(got).__name__ == type(want).__name__
    assert {k: getattr(got, k) for k in kw} == kw
    for f in ("H", "W", "num_rays", "height_camera_view_pu", "obs_type", "raycast_backend"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.ray_fan_lut, want.ray_fan_lut)
    with pytest.raises(ValueError):
        config.replace(base, num_rays=1)


def test_palette_rgb_f32():
    assert colors.PALETTE_RGB_F32.dtype == jcolors.PALETTE_RGB_F32.dtype == np.float32
    np.testing.assert_array_equal(colors.PALETTE_RGB_F32, jcolors.PALETTE_RGB_F32)
    np.testing.assert_array_equal(colors.PALETTE_RGB_F32, rt.EnvConfig().palette_rgb_f32)


def test_rgb_to_u32():
    """Against the JAX function, and the inverse of u32_to_rgb both ways."""
    r = np.random.default_rng(0)
    rgb = r.integers(0, 256, size=(5, 7, 3)).astype(np.uint8)
    got = colors.rgb_to_u32(rgb)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jcolors.rgb_to_u32(rgb))
    np.testing.assert_array_equal(colors.u32_to_rgb(got), rgb)
    img = r.integers(0, 1 << 24, size=(4, 9)).astype(np.uint32)
    np.testing.assert_array_equal(colors.rgb_to_u32(colors.u32_to_rgb(img)), img)
    np.testing.assert_array_equal(colors.rgb_to_u32(colors.u32_to_rgb(colors.PALETTE_NP)),
                                  colors.PALETTE_NP)


def _walls(h=8, w=8):
    m = np.zeros((h, w), dtype=bool)
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = True
    return m


@pytest.mark.parametrize("pos,want", [((4.0, 4.0), False), ((1.05, 4.0), True),
                                      ((1.2, 4.0), False), ((6.9, 6.9), True),
                                      ((0.5, 0.5), True)])
def test_is_player_colliding_cases(pos, want):
    """tests/test_collision.py's border cases (and a corner, and a circle
    inside the border ring, whose 3x3 gathers clamp at the edge)."""
    walls = _walls()
    p = np.array(pos, np.float32)
    got = collision.is_player_colliding(torch.from_numpy(walls), torch.from_numpy(p), 0.125)
    assert got.shape == () and got.dtype == torch.bool
    assert bool(got) == want
    assert bool(jcollision.is_player_colliding(jnp.asarray(walls), jnp.asarray(p), 0.125)) == want


def test_is_player_colliding_matches_goal_test():
    """The 3x3 map scan over a one-goal map equals the single-AABB goal
    test and the JAX scan (tests/test_collision.py's property)."""
    r = np.random.default_rng(0)
    for _ in range(50):
        pos = r.uniform(1.0, 7.0, size=2).astype(np.float32)
        goal = r.integers(1, 7, size=2).astype(np.int32)
        goal_map = np.zeros((8, 8), bool)
        goal_map[goal[0], goal[1]] = True
        a = bool(collision.is_colliding_with_goal(torch.from_numpy(pos), torch.from_numpy(goal),
                                                  0.125))
        b = bool(collision.is_player_colliding(torch.from_numpy(goal_map),
                                               torch.from_numpy(pos), 0.125))
        c = bool(jcollision.is_player_colliding(jnp.asarray(goal_map), jnp.asarray(pos), 0.125))
        assert a == b == c, (pos, goal)


def _poses(cfg, n, seed):
    """n random interior positions (half at tile centres) and headings."""
    r = np.random.default_rng(seed)
    pos = r.uniform([1.0, 1.0], [cfg.H - 1.0, cfg.W - 1.0], size=(n, 2)).astype(np.float32)
    pos[::2] = np.floor(pos[::2]) + np.float32(0.5)
    dir_au = r.integers(0, cfg.num_directions, size=n).astype(np.int32)
    dir_au[:8:2] = np.arange(4) * (cfg.num_directions // 4)
    return pos, dir_au


def test_cast_rays_analytic():
    """One env's border + goal cast: exact against the port's batch cast at
    B=1; against JAX, hit tiles and faces exact on every goal hit and where
    the wall crossing lies more than 1e-5 from a grid line, distances to
    1e-6 relative (the analytic backend's contract)."""
    kw = dict(num_rays=33, height_camera_view_pu=24)
    cfg, jcfg = rt.EnvConfig(**kw), rcw.EnvConfig(**kw)
    pos, dir_au = _poses(cfg, 24, 1)
    goals = np.random.default_rng(2).integers([1, 1], [cfg.H - 1, cfg.W - 1], size=(24, 2))
    goals = goals.astype(np.int32)
    n_safe = n_goal = 0
    for p, d, g in zip(pos, dir_au, goals):
        hits = raycast_analytic.cast_rays_analytic(
            cfg, torch.from_numpy(g), torch.from_numpy(p), torch.tensor(d))
        dirs = torch.from_numpy(cfg.ray_fan_lut[d])
        want = raycast_analytic.cast_rays_boxes(
            cfg, torch.from_numpy(g)[None, None], torch.from_numpy(p)[None], dirs[None])
        for a, b in zip(hits, want):
            assert a.shape == b.shape[1:] and torch.equal(a, b[0])
        jh = janalytic.cast_rays_analytic(jcfg, jnp.asarray(g), jnp.asarray(p), jnp.asarray(d))
        np.testing.assert_array_equal(hits.ray_dirs.numpy(), np.asarray(jh.ray_dirs))
        np.testing.assert_allclose(hits.dist_wu.numpy(), np.asarray(jh.dist_wu), rtol=1e-6)
        ht, hd, t = hits.hit_tu.numpy(), hits.hit_dim.numpy(), hits.dist_wu.numpy()
        on_goal = (ht == g).all(axis=-1)
        d_np = cfg.ray_fan_lut[d]
        cross = np.where(hd == 1, p[0] + t * d_np[:, 0], p[1] + t * d_np[:, 1])
        safe = on_goal | (np.abs(cross - np.round(cross)) > 1e-5)
        np.testing.assert_array_equal(ht[safe], np.asarray(jh.hit_tu)[safe])
        np.testing.assert_array_equal(hd[safe], np.asarray(jh.hit_dim)[safe])
        n_safe += int(safe.sum())
        n_goal += int(on_goal.sum())
    assert n_goal > 0 and n_safe > 0.5 * 24 * 33


@pytest.mark.parametrize("h,w,density", [(8, 16, 0.0), (13, 9, 0.25), (16, 16, 0.3)])
def test_cast_rays_pallas(h, w, density):
    """One env's DDA cast: on a CPU tensor the plain scan at [1, R], exact
    against the JAX Pallas kernel's single-env wrapper (interpret mode)."""
    kw = dict(num_rays=64, height_camera_view_pu=24, height_tile_map_tu=h,
              width_tile_map_tu=w, raycast_backend="pallas")
    cfg, jcfg = rt.EnvConfig(**kw), rcw.EnvConfig(**kw)
    r = np.random.default_rng(h)
    walls = _walls(h, w) | (r.random((h, w)) < density)
    pos, dir_au = _poses(cfg, 8, h)
    for p, d in zip(pos, dir_au):
        m = walls.copy()
        m[int(p[0]), int(p[1])] = False
        words = bitmap.pack_bits(torch.from_numpy(m)[None])[0]
        hits = raycast_pallas.cast_rays_pallas(cfg, words, torch.from_numpy(p), torch.tensor(d))
        scan = raycast.cast_rays_scan(words[None], (h, w), torch.from_numpy(p)[None],
                                      hits.ray_dirs[None], cfg.dda_steps)
        for a, b in zip(hits[1:], scan):
            assert torch.equal(a, b[0])
        jh = jpallas.cast_rays_pallas(
            jcfg, jnp.asarray(words.numpy().view(np.uint32)), jnp.asarray(p), jnp.asarray(d))
        for field in ("ray_dirs", "hit_tu", "hit_dim", "dist_wu"):
            got, want = getattr(hits, field).numpy(), np.asarray(getattr(jh, field))
            assert got.dtype == want.dtype and got.shape == want.shape, field
            np.testing.assert_array_equal(got, want, err_msg=field)
