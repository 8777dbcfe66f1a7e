"""The analytic (closed-form box) raycaster against the JAX package.

The JAX package holds this backend to the DDA's hit tiles and faces with
distances to ~1e-6 (docs/PARITY.md), not bit for bit, and XLA on the CPU
contracts the wall crossing ``p + t*d`` into an FMA where the port rounds
twice.  So the port is held:
  * exactly, hit tiles, faces and distances, to a numpy evaluation of the
    same expressions with one rounding per op;
  * exactly against JAX on hit tiles and faces wherever the wall crossing
    coordinate lies more than 1e-5 from an integer (and on every box hit);
  * to 1e-6 relative against JAX on every distance.
Cases: SingleRoom, MultiGoalRoom with collected goals at (-1, -1) and
DynamicRoom, at random interior positions and tile centres, with an odd
ray count (exact-zero ray components); RandomRoom falls through to the scan.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu as rcw
import raycastworlds_tpu_torch as rt
from raycastworlds_tpu.ops import raycast_analytic as janalytic

B = 48
KW = dict(num_rays=33, height_camera_view_pu=24, raycast_backend="analytic")


def _np_cast_boxes(h, w, boxes, pos, dirs):
    """The analytic cast in numpy float32, one rounding per op."""
    f = np.float32
    dx, dy = dirs[..., 0], dirs[..., 1]
    px, py = pos[:, 0:1], pos[:, 1:2]
    inf = f(np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_i = np.where(dx != 0, (np.where(dx > 0, f(h - 1), f(1)) - px) / dx, inf)
        t_j = np.where(dy != 0, (np.where(dy > 0, f(w - 1), f(1)) - py) / dy, inf)
        wall_dim = np.where(t_i < t_j, 0, 1)
        t_wall = np.minimum(t_i, t_j)
        ci = np.floor(px + t_wall * dx).astype(np.int32)
        cj = np.floor(py + t_wall * dy).astype(np.int32)
        wi = np.clip(np.where(wall_dim == 0, np.where(dx > 0, h - 1, 0), ci), 0, h - 1)
        wj = np.clip(np.where(wall_dim == 1, np.where(dy > 0, w - 1, 0), cj), 0, w - 1)
        g0 = boxes.astype(f)[:, None]
        g1 = g0 + f(1)
        dxk, dyk = dx[..., None], dy[..., None]
        pxk, pyk = px[..., None], py[..., None]
        tx1 = np.where(dxk != 0, (g0[..., 0] - pxk) / dxk, np.where(pxk >= g0[..., 0], -inf, inf))
        tx2 = np.where(dxk != 0, (g1[..., 0] - pxk) / dxk, np.where(pxk <= g1[..., 0], inf, -inf))
        ty1 = np.where(dyk != 0, (g0[..., 1] - pyk) / dyk, np.where(pyk >= g0[..., 1], -inf, inf))
        ty2 = np.where(dyk != 0, (g1[..., 1] - pyk) / dyk, np.where(pyk <= g1[..., 1], inf, -inf))
    tx_in, tx_out = np.minimum(tx1, tx2), np.maximum(tx1, tx2)
    ty_in, ty_out = np.minimum(ty1, ty2), np.maximum(ty1, ty2)
    t_enter, t_exit = np.maximum(tx_in, ty_in), np.minimum(tx_out, ty_out)
    t_box = np.where((t_enter > 0) & (t_enter <= t_exit), t_enter, inf)
    best = np.argmin(t_box, axis=-1)
    t_best = np.take_along_axis(t_box, best[..., None], -1)[..., 0]
    dim_best = np.take_along_axis(np.where(tx_in >= ty_in, 0, 1), best[..., None], -1)[..., 0]
    bt = np.take_along_axis(boxes[:, None, :, :], best[..., None, None], 2)[:, :, 0]
    use_box = t_best < t_wall
    hit = np.where(use_box[..., None], bt, np.stack([wi, wj], -1))
    return (hit.astype(np.int32), np.where(use_box, dim_best, wall_dim).astype(np.int32),
            np.where(use_box, t_best, t_wall).astype(f), use_box,
            px + t_wall * dx, py + t_wall * dy, wall_dim)


def _state(game, seed):
    """A reset state with random interior positions (half at tile
    centres) and random headings (four along the axes, whose middle ray
    has an exact-zero component)."""
    cfg = game.cfg
    st = game.reset_batch(rt.rng.split(rt.rng.PRNGKey(seed), B))
    r = np.random.default_rng(seed)
    pos = r.uniform([1.0, 1.0], [cfg.H - 1.0, cfg.W - 1.0], size=(B, 2)).astype(np.float32)
    pos[::2] = np.floor(pos[::2]) + np.float32(0.5)
    dir_au = r.integers(0, cfg.num_directions, size=B).astype(np.int32)
    dir_au[:8:2] = np.arange(4) * (cfg.num_directions // 4)   # axis headings
    return st.replace(pos_wu=torch.from_numpy(pos), dir_au=torch.from_numpy(dir_au))


CASES = {
    "single_room": (rt.SingleRoom, rt.EnvConfig, {}),
    "multi_goal": (rt.MultiGoalRoom, rt.MultiGoalConfig, dict(num_goals=5)),
    "dynamic_room": (rt.DynamicRoom, rt.DynamicRoomConfig, dict(num_blocks=4)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_analytic_cast(name):
    game_cls, cfg_cls, kw = CASES[name]
    game = game_cls(cfg_cls(**KW, **kw))
    cfg = game.cfg
    st = _state(game, seed=len(name))
    if name == "multi_goal":  # collected goals are disabled rows
        tiles = st.goal_tiles.clone()
        tiles[::3, 1:3] = -1
        st = st.replace(goal_tiles=tiles)
    boxes = game._analytic_boxes(st)
    hits = game.cast_batch(st)
    pos, dirs = st.pos_wu.numpy(), hits.ray_dirs.numpy()
    np.testing.assert_array_equal(dirs, cfg.ray_fan_lut[st.dir_au.numpy()])
    assert (dirs == 0).any()  # 33 rays: exact-zero components

    n_hit, n_dim, n_dist, use_box, xi, xj, wall_dim = _np_cast_boxes(
        cfg.H, cfg.W, boxes.numpy(), pos, dirs)
    np.testing.assert_array_equal(hits.hit_tu.numpy(), n_hit)
    np.testing.assert_array_equal(hits.hit_dim.numpy(), n_dim)
    np.testing.assert_array_equal(hits.dist_wu.numpy(), n_dist)
    assert use_box.any() and (~use_box).any()

    jcfg = getattr(rcw, cfg_cls.__name__)(**KW, **kw)
    jh = jax.vmap(lambda b, p, d: janalytic.cast_rays_boxes(jcfg, b, p, d))(
        jnp.asarray(boxes.numpy()), jnp.asarray(pos), jnp.asarray(st.dir_au.numpy()))
    # wall rays: the crossing coordinate along the face (i on a j face, j
    # on an i face) is what floor() decides
    cross = np.where(wall_dim == 1, xi, xj)
    safe = use_box | (np.abs(cross - np.round(cross)) > 1e-5)
    assert safe.mean() > 0.5
    np.testing.assert_array_equal(hits.hit_tu.numpy()[safe], np.asarray(jh.hit_tu)[safe])
    np.testing.assert_array_equal(hits.hit_dim.numpy()[safe], np.asarray(jh.hit_dim)[safe])
    np.testing.assert_allclose(hits.dist_wu.numpy(), np.asarray(jh.dist_wu), rtol=1e-6)


def test_analytic_falls_through_to_scan():
    """RandomRoom is not border ring + boxes: ``analytic`` casts through
    the scan, as the JAX package's cast_rays does."""
    kw = dict(KW, height_tile_map_tu=10, width_tile_map_tu=10)
    game = rt.RandomRoom(rt.RandomRoomConfig(**kw))
    scan = rt.RandomRoom(rt.RandomRoomConfig(**dict(kw, raycast_backend="scan")))
    assert not game.supports_analytic_raycast
    st = game.reset_batch(rt.rng.split(rt.rng.PRNGKey(3), 8))
    got, want = game.cast_batch(st), scan.cast_batch(st)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jgame = rcw.RandomRoom(rcw.RandomRoomConfig(**kw))
    js = jax.vmap(jgame.reset_single)(jnp.asarray(
        rt.rng.split(rt.rng.PRNGKey(3), 8).numpy().astype(np.uint32)))
    jh = jax.jit(jgame.cast_batch)(js)
    np.testing.assert_array_equal(got.hit_tu.numpy(), np.asarray(jh.hit_tu))
    np.testing.assert_array_equal(got.dist_wu.numpy(), np.asarray(jh.dist_wu))


def test_analytic_env_states_match_crossing():
    """States never depend on the cast: an analytic MultiGoalRoom Env ends in
    the crossing Env's state, and its frames differ from the crossing's only
    where a column height sits on a rounding edge."""
    cfg = rt.MultiGoalConfig(**dict(KW, num_rays=32))
    envs = [rt.Env(rt.MultiGoalRoom(c), num_envs=8, device="cpu")
            for c in (cfg, dataclasses.replace(cfg, raycast_backend="crossing"))]
    out = []
    for env in envs:
        st, _ = env.reset(rt.rng.PRNGKey(1))
        for a in np.random.default_rng(0).integers(0, 4, size=(10, 8)):
            res = env.step(st, torch.from_numpy(a.astype(np.int32)))
            st = res.state
        out.append((st, res.obs.view(torch.int32).numpy()))
    for k, v in out[0][0].leaves().items():
        assert torch.equal(v, out[1][0].leaves()[k]), k
    assert (out[0][1] == out[1][1]).mean() > 0.999
