"""Wall textures and the extended pal8 palette of the port against the JAX
package.

* ``colors.texture_factors``, ``build_texture_palette`` and
  ``palette_rgb_f32`` (and ``EnvConfig.palette_np``/``palette_rgb_f32``)
  are array-equal for checker, brick and xor at texture_cells 2, 8 and 40.
* ``render._texture_uv`` and ``_texture_factor_index`` are exact against
  the JAX functions run eagerly on numpy-seeded hits, distances down to
  1e-5 included, at texture_cells 8 and 32768 (where the column-height cap
  shrinks to 16384).  Jitted, XLA on the CPU contracts the cross coordinate
  ``pos + dist * dir`` into an FMA; the count of texel columns that moves
  is reported.
* Textured SingleRoom and DynamicRoom (the block slot) through ``Env``
  against the jitted JAX ``Env`` in camera_u32 and camera_pal8, under the
  plain versions of the crossing and DDA kernels and the plain casts, over
  resets, steps, goal terminations, truncations and auto-resets: every
  state leaf, reward, done and info entry exact at every step; observations
  exact, or, on the envs where a jitted-JAX pixel differs (the FMAs of the
  cross coordinate and of the xor factor ``0.4 + 0.6 * g``), exact against
  the same JAX code run eagerly.
* pal8 frames decode to the u32 frames of the same states for all three
  textures; the cases of the JAX package's tests/test_textures.py on the
  port; one textured MultiPlayerRoom frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu import colors as jcolors
from raycastworlds_tpu.ops import raycast as jraycast
from raycastworlds_tpu.ops import render as jrender
from raycastworlds_tpu_torch import colors
from raycastworlds_tpu_torch.ops import raycast, render
from raycastworlds_tpu_torch.state import LEAVES, OPTIONAL_LEAVES

TEXTURES = ("checker", "brick", "xor")


def np_(x):
    return x.detach().cpu().numpy()


# -- factors and palettes ------------------------------------------------------


@pytest.mark.parametrize("cells", [2, 8, 40])
@pytest.mark.parametrize("tex", TEXTURES)
def test_texture_factors_and_palette_match_jax(tex, cells):
    got, want = colors.texture_factors(tex, cells), jcolors.texture_factors(tex, cells)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    pal = colors.build_texture_palette(tex, cells)
    assert pal.dtype == np.uint32 and pal.shape == (12 + 6 * len(want),)
    np.testing.assert_array_equal(pal, jcolors.build_texture_palette(tex, cells))
    np.testing.assert_array_equal(colors.palette_rgb_f32(pal), jcolors.palette_rgb_f32(pal))
    kw = dict(wall_texture=tex, texture_cells=cells, obs_type="camera_pal8")
    cfg, jcfg = rt.EnvConfig(**kw), rcw.EnvConfig(**kw)
    np.testing.assert_array_equal(cfg.palette_np, jcfg.palette_np)
    np.testing.assert_array_equal(cfg.palette_rgb_f32, jcfg.palette_rgb_f32)
    np.testing.assert_array_equal(rt.EnvConfig().palette_np, jcolors.PALETTE_NP)


def test_palette_cap():
    with pytest.raises(ValueError, match="pal8 fits at most 40"):
        colors.build_texture_palette("xor", 41)


# -- texel coordinates ----------------------------------------------------------


def texel_inputs(cells, seed=0, b=32, r=48, hpu=40):
    """Config and numpy-seeded hits: positions in an 8x16 room, unit rays,
    hit tiles and faces, distances log-uniform in [1e-5, 20] (so that some
    column heights pass the cap), and the column heights of the render."""
    cfg = dict(num_rays=r, height_camera_view_pu=hpu, wall_texture="checker",
               texture_cells=cells)
    rng = np.random.default_rng(seed)
    pos = rng.uniform([1, 1], [7, 15], size=(b, 2)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, size=(b, r))
    dirs = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    dist = np.exp(rng.uniform(np.log(1e-5), np.log(20), size=(b, r))).astype(np.float32)
    hit_dim = rng.integers(0, 2, size=(b, r)).astype(np.int32)
    cross = pos[:, None, :] + dist[..., None] * dirs
    hit_tu = np.floor(cross).astype(np.int32)
    pdir = dirs[:, r // 2]
    return cfg, dict(pos=pos, dirs=dirs, dist=dist, hit_dim=hit_dim, hit_tu=hit_tu,
                     pdir=pdir)


@pytest.mark.parametrize("cells", [8, 32768])
def test_texture_uv_and_factor_index_match_eager_jax(cells):
    kw, x = texel_inputs(cells)
    cfg, jcfg = rt.EnvConfig(**kw), rcw.EnvConfig(**kw)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    hits = raycast.RayHits(ray_dirs=t["dirs"], hit_tu=t["hit_tu"], hit_dim=t["hit_dim"],
                           dist_wu=t["dist"])
    _, height_line = render.column_pads(t["pdir"], hits, cfg.height_camera_view_pu,
                                        *render.render_constants(cfg))
    ui, vi = render._texture_uv(cfg, hits, t["pos"], height_line)
    hl = np_(height_line)
    cap = min(1 << 20, (1 << 30) // (2 * cells))
    assert (hl > cap).any() and (hl < 2).any()
    row = jnp.arange(jcfg.height_camera_view_pu, dtype=jnp.int32)[:, None]

    def one(p, d, ht, hd, ds, h):
        hh = jraycast.RayHits(ray_dirs=d, hit_tu=ht, hit_dim=hd, dist_wu=ds)
        return jrender._texture_uv(jcfg, hh, p, h, row)

    args = [x[k] for k in ("pos", "dirs", "hit_tu", "hit_dim", "dist")] + [hl]
    with jax.disable_jit():
        jui, jvi = jax.vmap(one)(*args)
    np.testing.assert_array_equal(np_(ui), np.asarray(jui))
    np.testing.assert_array_equal(np_(vi), np.asarray(jvi))
    assert len(np.unique(np_(ui))) > min(cells, 100) // 2
    for tex in TEXTURES:
        c, jc = (rt.EnvConfig(**{**kw, "wall_texture": tex}),
                 rcw.EnvConfig(**{**kw, "wall_texture": tex}))
        got = np_(render._texture_factor_index(c, ui, vi))
        want = np.asarray(jax.vmap(lambda u, v: jrender._texture_factor_index(jc, u, v))(
            jnp.asarray(np_(ui)), jnp.asarray(np_(vi))))
        np.testing.assert_array_equal(got, want, err_msg=tex)
    jitted, _ = jax.jit(jax.vmap(one))(*args)
    print(f"texture_cells={cells}: jitted JAX ui differs on "
          f"{int((np.asarray(jitted) != np_(ui)).sum())} of {ui.numel()} columns")


# -- through Env --------------------------------------------------------------

B = 8
STEPS = 24
SMALL = dict(num_rays=32, height_camera_view_pu=24, max_episode_steps=10)

CASES = {
    "single_room_checker_u32_auto": ("SingleRoom", "EnvConfig", dict(wall_texture="checker")),
    "single_room_xor_pal8_crossing_kernel_fused": (
        "SingleRoom", "EnvConfig",
        dict(wall_texture="xor", obs_type="camera_pal8", raycast_backend="crossing_kernel_fused")),
    "dynamic_room_brick_u32_pallas": (
        "DynamicRoom", "DynamicRoomConfig",
        dict(wall_texture="brick", raycast_backend="pallas", block_period=2)),
    "dynamic_room_xor_pal8_scan": (
        "DynamicRoom", "DynamicRoomConfig",
        dict(wall_texture="xor", texture_cells=16, obs_type="camera_pal8",
             raycast_backend="scan", block_period=2)),
}


def jax_leaves(state):
    out = {k: np.asarray(getattr(state, k)) for k in LEAVES}
    for k in OPTIONAL_LEAVES:
        if getattr(state, k) is not None:
            out[k] = np.asarray(getattr(state, k))
    return out


def assert_state_equal(got, want):
    g, w = got.to_numpy(), jax_leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


class ObsCheck:
    """Observations exact against the jitted JAX ones, or, on the envs where
    they differ, against the eager JAX observation of the same states (in
    one call at the end); counts the values that moved."""

    def __init__(self, jenv):
        self.jenv = jenv
        self.states, self.frames = [], []
        self.moved = 0

    def __call__(self, jstate, got, want):
        assert got.shape == want.shape and got.dtype == want.dtype
        bad = (got != want).reshape(len(got), -1).any(axis=1)
        if bad.any():
            envs = np.flatnonzero(bad)
            self.states.append(jax.tree_util.tree_map(lambda a: np.asarray(a)[envs], jstate))
            self.frames.append(got[envs])
            self.moved += int((got != want).sum())

    def explain(self):
        if not self.states:
            return
        sub = jax.tree_util.tree_map(lambda *xs: np.concatenate(xs), *self.states)
        with jax.disable_jit():
            eager = np.asarray(self.jenv.game.observe_batch(sub))
        np.testing.assert_array_equal(np.concatenate(self.frames), eager)


def make_envs(name):
    game, config, kw = CASES[name]
    ckw = {**SMALL, **kw}
    jenv = rcw.Env(getattr(rcw, game)(getattr(rcw, config)(**ckw)), num_envs=B)
    env = rt.Env(getattr(rt, game)(getattr(rt, config)(**ckw)), num_envs=B, device="cpu")
    return jenv, env


@pytest.mark.parametrize("name", list(CASES))
def test_textured_env_matches_jax(name):
    jenv, env = make_envs(name)
    check = ObsCheck(jenv)
    js, jobs = jenv.reset(jax.random.PRNGKey(3))
    ts, tobs = env.reset(rt.rng.PRNGKey(3))
    assert_state_equal(ts, js)
    check(js, np_(tobs), np.asarray(jobs))
    # envs 0-3 0.3 above their goal tile, facing it: goals within 3 steps
    pos, dir_au = np.asarray(js.pos_wu).copy(), np.asarray(js.dir_au).copy()
    pos[:4] = np.asarray(js.goal_tu)[:4] + np.array([-0.3, 0.5], np.float32)
    dir_au[:4] = 0
    js = js.replace(pos_wu=jnp.asarray(pos), dir_au=jnp.asarray(dir_au))
    ts = rt.EnvState.from_numpy({**jax_leaves(js), "hw": js.hw})
    actions = np.random.default_rng(1).choice(
        4, size=(STEPS, B), p=[0.55, 0.05, 0.2, 0.2]).astype(np.int32)
    actions[:3, :4] = 0
    n_term = n_trunc = 0
    for a in actions:
        jr = jenv.step(js, jnp.asarray(a))
        tr = env.step(ts, torch.from_numpy(a))
        assert_state_equal(tr.state, jr.state)
        np.testing.assert_array_equal(np_(tr.reward), np.asarray(jr.reward))
        np.testing.assert_array_equal(np_(tr.done), np.asarray(jr.done))
        for k in jr.info:
            np.testing.assert_array_equal(np_(tr.info[k]), np.asarray(jr.info[k]), err_msg=k)
        check(jr.state, np_(tr.obs), np.asarray(jr.obs))
        n_term += int(np.asarray(jr.info["terminated"]).sum())
        n_trunc += int(np.asarray(jr.info["truncated"]).sum())
        js, ts = jr.state, tr.state
    check.explain()
    print(f"{name}: {check.moved} pixels differ from jitted JAX, in "
          f"{sum(len(f) for f in check.frames)} env frames, all equal to eager JAX")
    assert n_term > 0 and n_trunc > 0
    obs = np_(tr.obs)
    assert len(np.unique(obs)) > 6  # ceiling, floor and textured slabs
    if name.startswith("dynamic_room"):  # the block slabs (slots 4, 5) are drawn
        nf = len(colors.texture_factors(env.cfg.wall_texture, env.cfg.texture_cells))
        block = np.arange(colors.PAL_TEX_BASE + 4 * nf, colors.PAL_TEX_BASE + 6 * nf)
        if env.cfg.obs_type == "camera_u32":
            block = env.cfg.palette_np[block]
        assert np.isin(obs, block).any()


@pytest.mark.parametrize("tex", TEXTURES)
def test_pal8_decodes_to_u32(tex):
    """camera_pal8 frames decode through ``cfg.palette_np`` to the
    camera_u32 frames of the same states (DynamicRoom: all six slabs)."""
    kw = dict(num_rays=48, height_camera_view_pu=40, wall_texture=tex, texture_cells=8)
    g8 = rt.DynamicRoom(rt.DynamicRoomConfig(**kw, obs_type="camera_pal8"))
    g32 = rt.DynamicRoom(rt.DynamicRoomConfig(**kw))
    state = g8.reset_batch(rt.rng.split(rt.rng.PRNGKey(4), 16))
    for q in range(6):
        a = rt.rng.randint(rt.rng.PRNGKey(10 + q), (16,), 0, 4)
        state = g8.step_batch(state, a)
        pal8 = g8.observe_batch(state)
        u32 = g32.observe_batch(state)
        decoded = render.pal8_to_u32(pal8, g8.cfg.palette_np)
        assert torch.equal(decoded.view(torch.int32), u32.view(torch.int32))
        np.testing.assert_array_equal(
            colors.pal8_to_u32_np(np_(pal8), g8.cfg.palette_np), np_(u32.view(torch.int32))
            .view(np.uint32))
    assert int(pal8.max()) >= colors.PAL_TEX_BASE


# -- tests/test_textures.py of the JAX package, on the port ------------------


def _render(cfg, key=0):
    game = rt.SingleRoom(cfg)
    state = game.reset_batch(rt.rng.PRNGKey(key)[None])
    return np_(game.camera_view_batch(state)[0].view(torch.int32)).view(np.uint32), state


def _cfg(**kw):
    kw.setdefault("num_rays", 64)
    kw.setdefault("height_camera_view_pu", 64)
    return rt.EnvConfig(**kw)


def test_texture_none_is_bit_identical_to_default():
    np.testing.assert_array_equal(_render(_cfg())[0], _render(_cfg(wall_texture="none"))[0])


@pytest.mark.parametrize("tex", TEXTURES)
def test_textured_walls_vary_within_columns(tex):
    img, _ = _render(_cfg(wall_texture=tex))
    flat, _ = _render(_cfg())
    np.testing.assert_array_equal(img == colors.CEILING, flat == colors.CEILING)
    np.testing.assert_array_equal(img == colors.FLOOR, flat == colors.FLOOR)
    wall = (flat != colors.CEILING) & (flat != colors.FLOOR)
    distinct = sum(1 for c in range(img.shape[1])
                   if wall[:, c].sum() > 8 and len(np.unique(img[wall[:, c], c])) > 1)
    assert distinct > img.shape[1] // 4, f"{tex}: {distinct}/{img.shape[1]}"


def test_texture_u_coordinate_is_view_independent():
    """Facing +x from (4.5, 8.25), the centre ray hits the far wall's i-face;
    its rendered column shows exactly the two checker shades."""
    cfg = _cfg(wall_texture="checker", texture_cells=8, num_rays=65)
    game = rt.SingleRoom(cfg)
    state = game.reset_batch(rt.rng.PRNGKey(0)[None])
    state = state.replace(pos_wu=torch.tensor([[4.5, 8.25]]),
                          dir_au=torch.zeros(1, dtype=torch.int32),
                          goal_tu=torch.tensor([[1, 1]], dtype=torch.int32))
    hits = game.cast_batch(state)
    mid = cfg.num_rays // 2
    assert int(hits.hit_tu[0, mid, 0]) == cfg.H - 1 and int(hits.hit_dim[0, mid]) == 0
    u = 8.25 + float(hits.dist_wu[0, mid]) * float(hits.ray_dirs[0, mid, 1])
    assert 0.0 <= u - int(hits.hit_tu[0, mid, 1]) < 1.0
    img = np_(game.camera_view_batch(state)[0].view(torch.int32)).view(np.uint32)
    col = img[:, cfg.num_rays - 1 - mid]
    rows = np.flatnonzero((col != colors.CEILING) & (col != colors.FLOOR))
    assert len(rows) > 4 and len(np.unique(col[rows])) == 2


def test_texture_validation():
    with pytest.raises(ValueError):
        _cfg(wall_texture="marble")
    with pytest.raises(ValueError):
        _cfg(texture_cells=1)


def test_textured_env_rollout():
    env = rt.Env(rt.SingleRoom(_cfg(wall_texture="brick", obs_type="camera_rgb")),
                 num_envs=4, device="cpu")
    state, obs = env.reset(rt.rng.PRNGKey(0))
    assert obs.shape == (4, 64, 64, 3) and obs.dtype == torch.uint8
    res = env.step(state, torch.zeros(4, dtype=torch.int32))
    assert bool(torch.isfinite(res.reward).all())


# -- MultiPlayerRoom --------------------------------------------------------------


def test_textured_multi_player_frame_matches_jax():
    """Each player's textured walls from that player's position: the port's
    camera views of 2 players x 4 envs after a reset and two steps equal the
    JAX package's, eagerly where the jitted frame moved."""
    kw = dict(num_players=2, num_rays=32, height_camera_view_pu=32, wall_texture="checker")
    jenv = rcw.Env(rcw.MultiPlayerRoom(rcw.MultiPlayerConfig(**kw)), num_envs=4)
    env = rt.Env(rt.MultiPlayerRoom(rt.MultiPlayerConfig(**kw)), num_envs=4, device="cpu")
    js, _ = jenv.reset(jax.random.PRNGKey(2))
    ts, _ = env.reset(rt.rng.PRNGKey(2))
    check = ObsCheck(jenv)
    for a in (np.full((4, 2), 2, np.int32), np.zeros((4, 2), np.int32)):
        jr, tr = jenv.step(js, jnp.asarray(a)), env.step(ts, torch.from_numpy(a))
        assert_state_equal(tr.state, jr.state)
        check(jr.state, np_(tr.obs), np.asarray(jr.obs))
        js, ts = jr.state, tr.state
    check.explain()
    obs = np_(tr.obs)
    assert obs.shape == (4, 2, 32, 32)
    assert not np.array_equal(obs[:, 0], obs[:, 1])
    assert len(np.unique(obs)) > 6
