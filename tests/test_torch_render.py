"""The port's camera renders vs the JAX package's, on fixed cast hits.

Images (u32, pal8, rgb, gray_u8) and the palette decode are exact.  The
float observations (``depth``, ``camera_gray``) are exact against a numpy
evaluation that rounds every mul and add, as the port does; against the
JAX package they are held to ``MAX_ULP``, because XLA on the CPU
contracts ``a*b + c`` into an FMA (measured on this package's own
expressions: ``pdx*dx + pdy*dy`` and the luma weights).  The luma is two
contracted mul+adds and a divide, each up to one rounding apart; 3 ulp was
the largest difference measured over random colours.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu.ops import raycast as jraycast
from raycastworlds_tpu.ops import render as jrender
from raycastworlds_tpu.ops.bitmap import pack_bits_np
from raycastworlds_tpu_torch.ops import raycast, render

MAX_ULP = 4

OBS = ["camera_u32", "camera_pal8", "camera_rgb", "camera_gray",
       "camera_gray_u8", "depth"]


def _case(kw, b=6, seed=0, blocks=False):
    """Config pair, fixed hits from the JAX crossing cast on random maps,
    and the per-env inputs of the renderer, as numpy.  ``blocks``: block
    tiles on 20% of the other empty tiles, obstacles to the cast, and their
    packed words as ``block_words`` (None otherwise)."""
    jcfg = rcw.EnvConfig(**kw)
    h, w = jcfg.H, jcfg.W
    r = np.random.default_rng(seed)
    walls = r.random((b, h, w)) < 0.2
    walls[:, 0, :] = walls[:, -1, :] = True
    walls[:, :, 0] = walls[:, :, -1] = True
    goal = r.integers(1, [h - 1, w - 1], size=(b, 2)).astype(np.int32)
    walls[np.arange(b), goal[:, 0], goal[:, 1]] = False
    obst = walls.copy()
    obst[np.arange(b), goal[:, 0], goal[:, 1]] = True
    dir_au = r.integers(0, jcfg.num_directions, size=b).astype(np.int32)
    pos = (r.integers(1, [h - 1, w - 1], size=(b, 2)) + 0.5).astype(np.float32)
    block_words = None
    if blocks:
        bl = (r.random((b, h, w)) < 0.2) & ~obst
        pt = np.floor(pos).astype(np.int64)
        bl[np.arange(b), pt[:, 0], pt[:, 1]] = False
        obst |= bl
        block_words = pack_bits_np(bl)
    dirs = jcfg.ray_fan_lut[dir_au]
    pdir = jcfg.directions_wu[dir_au]
    hit_tu, hit_dim, dist = jax.vmap(
        lambda ww, p, d: jraycast.cast_rays_crossing(ww, (h, w), p, d)
    )(jnp.asarray(pack_bits_np(obst)), jnp.asarray(pos), jnp.asarray(dirs))
    return dict(
        jcfg=jcfg, cfg=rt.EnvConfig(**kw), wall_words=pack_bits_np(walls),
        block_words=block_words, goal=goal, pos=pos, pdir=pdir, dirs=dirs,
        hit_tu=np.asarray(hit_tu),
        hit_dim=np.asarray(hit_dim), dist=np.asarray(dist),
    )


def _jax_obs(c, obs_type):
    cfg = dataclasses.replace(c["jcfg"], obs_type=obs_type)

    def one(ww, g, pd, d, ht, hd, ds, bw=None):
        hits = jraycast.RayHits(ray_dirs=d, hit_tu=ht, hit_dim=hd, dist_wu=ds)
        return jrender.render_observation(cfg, ww, g, pd, hits, block_words=bw)

    args = [c[k] for k in ("wall_words", "goal", "pdir", "dirs", "hit_tu",
                           "hit_dim", "dist")]
    if c["block_words"] is not None:
        args.append(c["block_words"])
    return np.asarray(jax.jit(jax.vmap(one))(*map(jnp.asarray, args)))


def _torch_obs(c, obs_type):
    cfg = dataclasses.replace(c["cfg"], obs_type=obs_type)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    hits = raycast.RayHits(ray_dirs=t(c["dirs"]), hit_tu=t(c["hit_tu"]),
                           hit_dim=t(c["hit_dim"]), dist_wu=t(c["dist"]))
    words = t(c["wall_words"].view(np.int32))
    blocks = c["block_words"]
    if blocks is None:
        return render.render_observation(cfg, words, t(c["goal"]), t(c["pdir"]), hits)
    return render.render_observation(cfg, words, t(c["goal"]), t(c["pdir"]), hits,
                                     block_words=t(blocks.view(np.int32)))


def _np_depth(c):
    """Projected depth, every op rounded to float32 (numpy, unfused)."""
    pd, d = c["pdir"], c["dirs"]
    dot = pd[:, None, 0] * d[..., 0] + pd[:, None, 1] * d[..., 1]
    return np.flip(c["dist"] * dot, axis=1)


def _np_gray(u32):
    r = ((u32 >> 16) & 0xFF).astype(np.float32)
    g = ((u32 >> 8) & 0xFF).astype(np.float32)
    b = (u32 & 0xFF).astype(np.float32)
    s = np.float32(0.299) * r + np.float32(0.587) * g + np.float32(0.114) * b
    return s / np.float32(255.0)


CONFIGS = [
    dict(num_rays=64, height_camera_view_pu=48),
    dict(height_tile_map_tu=13, width_tile_map_tu=9, num_rays=37,
         height_camera_view_pu=31, semi_field_of_view_wu=0.5),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=["default_small", "odd"])
@pytest.mark.parametrize("obs_type", OBS)
def test_render_observation(kw, obs_type):
    c = _case(kw)
    got_t = _torch_obs(c, obs_type)
    assert got_t.dtype == rt.Env(rt.SingleRoom(
        rt.EnvConfig(**{**kw, "obs_type": obs_type})), device="cpu").observation_space.dtype
    got = got_t.numpy()
    want = _jax_obs(c, obs_type)
    assert got.shape == want.shape
    if obs_type == "depth":
        np.testing.assert_array_equal(got, _np_depth(c))
        np.testing.assert_array_max_ulp(got, want, maxulp=MAX_ULP)
    elif obs_type == "camera_gray":
        u32 = _torch_obs(c, "camera_u32").numpy()
        np.testing.assert_array_equal(got, _np_gray(u32))
        np.testing.assert_array_max_ulp(got, want, maxulp=MAX_ULP)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("obs_type", ["camera_u32", "camera_pal8", "camera_rgb"])
def test_render_observation_block_words(obs_type):
    """Block tiles render in the block shades on every unfused image path,
    as in the JAX package (DynamicRoom's blocks, LockedRoom's doors)."""
    c = _case(CONFIGS[1], b=8, seed=3, blocks=True)
    got = _torch_obs(c, obs_type).numpy()
    want = _jax_obs(c, obs_type)
    np.testing.assert_array_equal(got, want)
    # a block is in view
    if obs_type == "camera_rgb":
        assert ((want[..., 0] == 0) & (want[..., 1] == 0) & (want[..., 2] > 0)).any()
    else:
        shades = ((rt.colors.PAL_BLOCK_DIM_I, rt.colors.PAL_BLOCK_DIM_J)
                  if obs_type == "camera_pal8"
                  else (rt.colors.BLOCK_DIM_I, rt.colors.BLOCK_DIM_J))
        assert np.isin(want, shades).any()


@pytest.mark.parametrize("kw", CONFIGS, ids=["default_small", "odd"])
def test_pal8_decodes_to_u32(kw):
    c = _case(kw, seed=1)
    pal = _torch_obs(c, "camera_pal8")
    u32 = _torch_obs(c, "camera_u32")
    dec = render.pal8_to_u32(pal)
    assert dec.dtype == torch.uint32
    np.testing.assert_array_equal(dec.numpy(), u32.numpy())
    want = np.asarray(jax.jit(jrender.pal8_to_u32)(jnp.asarray(pal.numpy())))
    np.testing.assert_array_equal(dec.numpy(), want)
    np.testing.assert_array_equal(
        rt.colors.pal8_to_u32_np(pal.numpy()), u32.numpy()
    )


def test_conversions_on_all_colours():
    img = np.random.default_rng(5).integers(0, 2**24, size=(4, 33, 17)).astype(np.uint32)
    t = torch.from_numpy(img.view(np.int32).copy())
    np.testing.assert_array_equal(render.u32_to_rgb(t).numpy(),
                                  np.asarray(jrender.u32_to_rgb(jnp.asarray(img))))
    np.testing.assert_array_equal(render.u32_to_rgb(t).numpy(), rt.colors.u32_to_rgb(img))
    np.testing.assert_array_equal(render.u32_to_gray_u8(t).numpy(),
                                  np.asarray(jrender.u32_to_gray_u8(jnp.asarray(img))))
    np.testing.assert_array_equal(render.u32_to_gray(t).numpy(), _np_gray(img))
    np.testing.assert_array_max_ulp(
        render.u32_to_gray(t).numpy(),
        np.asarray(jax.jit(jrender.u32_to_gray)(jnp.asarray(img))), maxulp=MAX_ULP,
    )


def test_slab_slots():
    c = _case(CONFIGS[0], seed=2)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    hits = raycast.RayHits(ray_dirs=t(c["dirs"]), hit_tu=t(c["hit_tu"]),
                           hit_dim=t(c["hit_dim"]), dist_wu=t(c["dist"]))
    got = render._slab_slots(t(c["wall_words"].view(np.int32)), (8, 16), hits)

    def one(ww, d, ht, hd, ds):
        h = jraycast.RayHits(ray_dirs=d, hit_tu=ht, hit_dim=hd, dist_wu=ds)
        return jrender._slab_slots(ww, (8, 16), h)

    want = jax.vmap(one)(*map(jnp.asarray, (c["wall_words"], c["dirs"], c["hit_tu"],
                                            c["hit_dim"], c["dist"])))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_slab_slots_block_words():
    c = _case(CONFIGS[0], seed=2, blocks=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    hits = raycast.RayHits(ray_dirs=t(c["dirs"]), hit_tu=t(c["hit_tu"]),
                           hit_dim=t(c["hit_dim"]), dist_wu=t(c["dist"]))
    got = render._slab_slots(t(c["wall_words"].view(np.int32)), (8, 16), hits,
                             t(c["block_words"].view(np.int32)))

    def one(ww, d, ht, hd, ds, bw):
        h = jraycast.RayHits(ray_dirs=d, hit_tu=ht, hit_dim=hd, dist_wu=ds)
        return jrender._slab_slots(ww, (8, 16), h, bw)

    want = np.asarray(jax.vmap(one)(*map(jnp.asarray, (
        c["wall_words"], c["dirs"], c["hit_tu"], c["hit_dim"], c["dist"],
        c["block_words"]))))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 4).any()  # block slots occur


@pytest.mark.parametrize("what", ["tile_grid", "top_u32", "texture"])
def test_unported_render_paths_raise(what):
    """The tile grid is exact against the JAX package, block words
    included; a top view is not drawn from camera hits and raises; a
    textured render needs the ray origins (ValueError without them, as in
    the JAX package) and is exact against the JAX render run eagerly in
    camera_u32 and camera_pal8, with the pal8 frame decoding to the u32
    one through the extended palette."""
    c = _case(CONFIGS[0], blocks=True)
    if what == "tile_grid":
        got = _torch_obs(c, what)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), _jax_obs(c, what))
        assert set(np.unique(got.numpy())) == {0, 1, 2, 3}
        return
    if what == "texture":
        c["cfg"] = dataclasses.replace(c["cfg"], wall_texture="checker")
        c["jcfg"] = dataclasses.replace(c["jcfg"], wall_texture="checker")
        with pytest.raises(ValueError, match="pos_wu"):
            _torch_obs(c, "camera_u32")
        t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
        hits = raycast.RayHits(ray_dirs=t(c["dirs"]), hit_tu=t(c["hit_tu"]),
                               hit_dim=t(c["hit_dim"]), dist_wu=t(c["dist"]))
        args = (t(c["wall_words"].view(np.int32)), t(c["pdir"]), hits)
        kw = dict(block_words=t(c["block_words"].view(np.int32)), pos_wu=t(c["pos"]))
        u32 = render.render_camera_u32(c["cfg"], *args, **kw).view(torch.uint32).numpy()
        pal8 = render.render_camera_pal8(c["cfg"], *args, **kw).numpy()

        def one(pal, ww, pd, d, ht, hd, ds, bw, p):
            h = jraycast.RayHits(ray_dirs=d, hit_tu=ht, hit_dim=hd, dist_wu=ds)
            fn = jrender.render_camera_pal8 if pal else jrender.render_camera_u32
            return fn(c["jcfg"], ww, pd, h, bw, pos_wu=p)

        jargs = [jnp.asarray(c[k]) for k in ("wall_words", "pdir", "dirs", "hit_tu",
                                             "hit_dim", "dist", "block_words", "pos")]
        with jax.disable_jit():
            for pal, got in ((False, u32), (True, pal8)):
                want = np.asarray(jax.vmap(lambda *a: one(pal, *a))(*jargs))
                np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            render.pal8_to_u32(torch.from_numpy(pal8), c["cfg"].palette_np)
            .view(torch.uint32).numpy(), u32)
        assert len(np.unique(u32)) > 8 and pal8.max() >= rt.colors.PAL_TEX_BASE + 8
        return
    with pytest.raises(ValueError, match="topview"):
        _torch_obs(c, what)
