"""The fused DDA + u32 render (``ops/render_fused.py``) and the ``scan``,
``scan_flat``, ``pallas`` and ``fused`` backends vs the JAX package.

* The kernel's wrapper on CPU tensors runs its plain version (the scan and
  the u32 render) and launches nothing; it is held against the JAX
  package's Pallas kernel in interpret mode, with and without block words,
  on fans with no exact-zero component (exact).
* ``Game.observe_batch`` for each backend and observation form against the
  JAX package with the same config; a 20-step Env rollout of ``fused`` and
  ``pallas`` against the JAX ``scan`` env, frame by frame.  Images are
  exact; ``depth`` and ``camera_gray`` keep the 4-ulp rule of
  tests/test_torch_render.py (XLA's FMA contraction on the CPU).
* At 33 rays, heading 0 has the exact ray (1, 0): the port equals the JAX
  scan there, where the JAX Pallas kernels do not.
* On a CUDA card, the CUDA kernel against its plain version:
  ``python -m pytest tests/test_torch_fused_render.py -m cuda --noconftest``.
"""

import functools

import numpy as np
import pytest
import torch

import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch.ops import render, render_fused
from raycastworlds_tpu_torch.ops.bitmap import pack_bits_np
from raycastworlds_tpu_torch.utils import profiling
from test_torch_crossing import TINY

MAX_ULP = 4


def render_case(kw, b, seed, kind="random"):
    """Numpy inputs of the fused render kernels for ``EnvConfig(**kw)``:
    random walls (density 0.25) inside a border, block tiles on 15% of the
    other tiles, a goal on an empty interior tile (obstacles = walls |
    blocks | goal), random positions and headings, each heading's player
    direction and mirror-ordered fan.  Other ``kind``s: "no_border", the
    walls without a border ring; "sliding", integer positions, axis
    headings and exact axis player directions, and the first 4 rays along
    the heading; "tiny", the same at random positions with the first 4
    rays' cross component of magnitude in TINY; "corners", integer
    positions and diagonal headings, the first 4 rays along the heading."""
    cfg = rt.EnvConfig(**kw)
    h, w = cfg.H, cfg.W
    rng = np.random.default_rng(seed)

    def maps(density):
        m = rng.random((b, h, w)) < density
        if kind != "no_border":
            m[:, 0, :] = m[:, -1, :] = True
            m[:, :, 0] = m[:, :, -1] = True
        return m

    walls = maps(0.25)
    goal = rng.integers(1, [h - 1, w - 1], size=(b, 2)).astype(np.int32)
    walls[np.arange(b), goal[:, 0], goal[:, 1]] = False
    blocks = (rng.random((b, h, w)) < 0.15) & ~walls
    blocks[np.arange(b), goal[:, 0], goal[:, 1]] = False
    obst = walls | blocks
    obst[np.arange(b), goal[:, 0], goal[:, 1]] = True
    if kind in ("sliding", "tiny", "corners"):
        if kind == "tiny":
            pos = rng.uniform([1.0, 1.0], [h - 1.0, w - 1.0], size=(b, 2))
        else:
            pos = rng.integers(1, [h - 1, w - 1], size=(b, 2))
        pos = pos.astype(np.float32)
        q = rng.integers(0, 4, size=b)
        dir_au = (q * (cfg.num_directions // 4)).astype(np.int32)
        pdir = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], np.float32)[q]
        if kind == "corners":
            dir_au = dir_au + cfg.num_directions // 8
            pdir = cfg.directions_wu[dir_au]
        dirs = cfg.ray_fan_lut_flipped[dir_au].copy()
        dirs[:, :4] = pdir[:, None, :]
        if kind == "tiny":  # the component across the heading: 1 for q even
            tiny = TINY[rng.integers(0, len(TINY), size=(b, 4))]
            dirs[np.arange(b)[:, None], np.arange(4), (1 - q % 2)[:, None]] = (
                tiny * rng.choice(np.array([-1, 1], np.float32), size=(b, 4)))
    else:
        pos = rng.uniform([1.0, 1.0], [h - 1.0, w - 1.0], size=(b, 2)).astype(np.float32)
        dir_au = rng.integers(0, cfg.num_directions, size=b).astype(np.int32)
        pdir = cfg.directions_wu[dir_au]
        dirs = cfg.ray_fan_lut_flipped[dir_au]
    num, denom = render.render_constants(cfg)
    return dict(cfg=cfg, obstacle=pack_bits_np(obst), wall=pack_bits_np(walls),
                block=pack_bits_np(blocks), goal=goal, pos=pos, dir_au=dir_au,
                pdir=pdir, dirs=dirs, num=num, denom=denom)


def t(a):
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32 else a).copy())


CASES = [
    dict(num_rays=64, height_camera_view_pu=24),
    dict(height_tile_map_tu=13, width_tile_map_tu=9, num_directions=96,
         num_rays=32, height_camera_view_pu=17, semi_field_of_view_wu=0.5),
]


def _port_fused(c, blocks):
    cfg = c["cfg"]
    return render_fused.render_camera_fused_batched(
        t(c["obstacle"]), t(c["wall"]), (cfg.H, cfg.W), t(c["pos"]), t(c["pdir"]),
        t(c["dirs"]), cfg.dda_steps, cfg.height_camera_view_pu, c["num"],
        c["denom"], t(c["block"]) if blocks else None,
    )


@pytest.mark.parametrize("blocks", [False, True], ids=["no_blocks", "blocks"])
@pytest.mark.parametrize("kw", CASES, ids=["default_small", "odd"])
def test_wrapper_cpu_matches_pallas_interpret(kw, blocks):
    import jax.numpy as jnp
    from raycastworlds_tpu.ops import render_fused as jrf

    c = render_case(kw, 8, seed=30)
    assert (c["dirs"] != 0).all()
    cfg = c["cfg"]
    want = jrf.render_camera_fused_batched(
        jnp.asarray(c["obstacle"]), jnp.asarray(c["wall"]), (cfg.H, cfg.W),
        jnp.asarray(c["pos"]), jnp.asarray(c["pdir"]), jnp.asarray(c["dirs"]),
        cfg.dda_steps, cfg.height_camera_view_pu, c["num"], c["denom"],
        block_words=jnp.asarray(c["block"]) if blocks else None,
    )
    before = profiling.total("kernel_launches.dda_render_u32")
    got = _port_fused(c, blocks)
    assert profiling.total("kernel_launches.dda_render_u32") == before  # CPU: no launch
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_blocks_change_the_image():
    c = render_case(CASES[0], 8, seed=31)
    a, b = _port_fused(c, False), _port_fused(c, True)
    from raycastworlds_tpu_torch import colors

    assert not torch.equal(a, b)
    assert bool((b == colors.BLOCK_DIM_I).any() | (b == colors.BLOCK_DIM_J).any())


def test_config_entry_matches_jax():
    import jax.numpy as jnp
    import raycastworlds_tpu as rcw
    from raycastworlds_tpu.ops import render_fused as jrf

    c = render_case(CASES[0], 8, seed=32)
    want = jrf.render_camera_fused(
        rcw.EnvConfig(**CASES[0]), jnp.asarray(c["obstacle"]), jnp.asarray(c["wall"]),
        jnp.asarray(c["pos"]), jnp.asarray(c["dir_au"]),
    )
    got = render_fused.render_camera_fused(
        c["cfg"], t(c["obstacle"]), t(c["wall"]), t(c["pos"]), t(c["dir_au"]))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


@functools.lru_cache(maxsize=None)
def _jax_states(num_rays, hpu, b, seed, steps):
    import jax
    import jax.numpy as jnp
    import raycastworlds_tpu as rcw

    cfg = rcw.EnvConfig(num_rays=num_rays, height_camera_view_pu=hpu,
                        obs_type="depth", raycast_backend="crossing")
    jenv = rcw.Env(rcw.SingleRoom(cfg), num_envs=b)
    js, _ = jenv.reset(jax.random.PRNGKey(seed))
    acts = np.random.default_rng(seed).integers(0, 4, size=(steps, b)).astype(np.int32)
    for a in acts:
        js = jenv.step(js, jnp.asarray(a)).state
    return js


def states_after_steps(kw, b, seed, steps=3):
    """(JAX state, port state): a JAX Env reset and a few numpy-seeded
    steps, so that positions leave the tile centres.  The dynamics do not
    depend on the observation or the backend, so one state serves every
    config with the same rays and camera height."""
    from raycastworlds_tpu_torch.state import LEAVES

    js = _jax_states(kw["num_rays"], kw["height_camera_view_pu"], b, seed, steps)
    leaves = {k: np.asarray(getattr(js, k)) for k in LEAVES}
    return js, rt.EnvState.from_numpy({**leaves, "hw": js.hw})


def assert_obs_equal(obs_type, got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if obs_type in ("depth", "camera_gray"):
        np.testing.assert_array_max_ulp(got, want, maxulp=MAX_ULP)
    else:
        np.testing.assert_array_equal(got, want)


OBS = ["camera_u32", "camera_rgb", "camera_gray", "camera_pal8",
       "camera_gray_u8", "depth"]


def observe_both(kw, seed=33):
    import jax
    import raycastworlds_tpu as rcw

    js, ts = states_after_steps(kw, 8, seed)
    want = np.asarray(jax.jit(rcw.SingleRoom(rcw.EnvConfig(**kw)).observe_batch)(js))
    got = rt.SingleRoom(rt.EnvConfig(**kw)).observe_batch(ts).numpy()
    return got, want


@pytest.mark.parametrize("obs_type", OBS)
@pytest.mark.parametrize("backend", ["scan", "scan_flat", "pallas", "fused"])
def test_observe_batch_matches_jax(backend, obs_type):
    kw = dict(num_rays=32, height_camera_view_pu=16, raycast_backend=backend,
              obs_type=obs_type)
    got, want = observe_both(kw)
    assert_obs_equal(obs_type, got, want)


def rollout_frames(env, reset, step, key, steps, b):
    state, obs = reset(key)
    frames, states = [obs], [state]
    acts = np.random.default_rng(5).choice(
        4, size=(steps, b), p=[0.55, 0.05, 0.2, 0.2]).astype(np.int32)
    for a in acts:
        res = step(state, a)
        state = res.state
        frames.append(res.obs)
        states.append(state)
    return frames, states


def assert_rollouts_equal(kw_port, kw_jax, b=8, steps=20):
    """A 20-step Env rollout with auto-reset through the port's config and
    the JAX package's, frame by frame and state by state."""
    import jax
    import jax.numpy as jnp
    import raycastworlds_tpu as rcw
    from raycastworlds_tpu_torch.state import LEAVES

    jenv = rcw.Env(rcw.SingleRoom(rcw.EnvConfig(**kw_jax)), num_envs=b)
    env = rt.Env(rt.SingleRoom(rt.EnvConfig(**kw_port)), num_envs=b, device="cpu")
    jf, js = rollout_frames(jenv, jenv.reset, lambda s, a: jenv.step(s, jnp.asarray(a)),
                            jax.random.PRNGKey(11), steps, b)
    tf, ts = rollout_frames(env, env.reset, lambda s, a: env.step(s, torch.from_numpy(a)),
                            rt.rng.PRNGKey(11), steps, b)
    n_reset = 0
    for k, (g, w, gs, ws) in enumerate(zip(tf, jf, ts, js)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"frame {k}")
        got = gs.to_numpy()
        for leaf in LEAVES:
            np.testing.assert_array_equal(got[leaf], np.asarray(getattr(ws, leaf)),
                                          err_msg=f"{leaf} at step {k}")
        n_reset += int(np.asarray(ws.done).sum())
    assert n_reset > 0  # auto-reset fired


@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_env_rollout_matches_jax_scan(backend):
    kw = dict(num_rays=32, height_camera_view_pu=16, max_episode_steps=8)
    assert_rollouts_equal(dict(kw, raycast_backend=backend),
                          dict(kw, raycast_backend="scan"))


@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_exact_zero_ray_matches_jax_scan(backend):
    """At 33 rays the middle ray of heading 0 is exactly (1, 0).  The JAX
    package's Pallas DDA kernels (``raycast_pallas`` and ``render_fused``)
    advance the untaken axis as ``side + go * delta``: on that ray delta_j
    is +inf, ``0 * inf`` is NaN, and from the second step on they march the
    wrong axis and give a NaN distance, so their frames differ from the JAX
    scan's.  The port's ``pallas`` and ``fused`` frames equal the scan's."""
    import jax
    import jax.numpy as jnp
    import raycastworlds_tpu as rcw

    kw = dict(num_rays=33, height_camera_view_pu=24)
    assert rt.EnvConfig(**kw).ray_fan_lut[0, 16].tolist() == [1.0, 0.0]
    js, ts = states_after_steps(kw, 8, seed=34, steps=0)
    js = js.replace(dir_au=jnp.zeros_like(js.dir_au))
    ts = ts.replace(dir_au=torch.zeros_like(ts.dir_au))
    jgame = lambda b: rcw.SingleRoom(rcw.EnvConfig(**kw, raycast_backend=b))  # noqa: E731
    scan = np.asarray(jax.jit(jgame("scan").observe_batch)(js))
    got = rt.SingleRoom(rt.EnvConfig(**kw, raycast_backend=backend)).observe_batch(ts)
    np.testing.assert_array_equal(got.numpy(), scan)
    # the reference-side fault this port does not copy
    jax_kernel = np.asarray(jax.jit(jgame(backend).observe_batch)(js))
    assert not np.array_equal(jax_kernel, scan)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [False, True], ids=["no_blocks", "blocks"])
@pytest.mark.parametrize("kind", ["random", "sliding"])
@pytest.mark.parametrize(
    "kw",
    [dict(num_rays=512), dict(height_tile_map_tu=24, width_tile_map_tu=40,
                              num_rays=129, height_camera_view_pu=100),
     dict(num_rays=65, height_camera_view_pu=48, max_dda_steps=3),
     dict(height_tile_map_tu=13, width_tile_map_tu=9, num_rays=513),
     dict(height_tile_map_tu=48, width_tile_map_tu=48, num_rays=256,
          height_camera_view_pu=100)],
    ids=["default", "wide_map", "truncated", "odd_map", "big_map"],
)
def test_cuda_kernel_matches_plain(cuda_device, kw, kind, blocks):
    c = render_case(kw, 16, seed=35, kind=kind)
    cfg = c["cfg"]
    d = lambda a: t(a).to(cuda_device)  # noqa: E731
    args = (d(c["obstacle"]), d(c["wall"]), (cfg.H, cfg.W), d(c["pos"]), d(c["pdir"]),
            d(c["dirs"]), cfg.dda_steps, cfg.height_camera_view_pu, c["num"],
            c["denom"], d(c["block"]) if blocks else None)
    before = profiling.total("kernel_launches.dda_render_u32")
    got = render_fused.render_camera_fused_batched(*args)
    torch.cuda.synchronize()
    assert profiling.total("kernel_launches.dda_render_u32") == before + 1
    want = render_fused.render_camera_fused_batched_ref(*args)
    assert torch.equal(got, want)


def test_wrapper_rejects_bad_inputs():
    c = render_case(CASES[0], 2, seed=36)
    cfg = c["cfg"]
    ok = dict(obstacle_words=t(c["obstacle"]), wall_words=t(c["wall"]),
              shape=(cfg.H, cfg.W), pos_wu=t(c["pos"]), player_dir_wu=t(c["pdir"]),
              ray_dirs_flipped=t(c["dirs"]), max_steps=24, hpu=24,
              num_f=c["num"], denom_f=c["denom"])
    for bad, err in ((dict(wall_words=t(c["wall"])[:1]), ValueError),
                     (dict(block_words=t(c["block"]).long()), TypeError),
                     (dict(player_dir_wu=t(c["pdir"]).double()), TypeError),
                     (dict(hpu=0), ValueError),
                     (dict(shape=(9, 16)), ValueError)):
        with pytest.raises(err):
            render_fused.render_camera_fused_batched(**dict(ok, **bad))
