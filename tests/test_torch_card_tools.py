"""On the card: the adapters and tools, each run launching ``crossing_cast``
once per observation or view and no other kernel.

* ``GymVectorAdapter`` at flagship_single_room_4096 (SingleRoom 64 x 64
  camera_u32 ``auto``, 4096 envs, reset + 64 steps): every array equal to
  ``Env.reset``/``Env.step`` on the card with the same keys, and its first
  256 envs x 16 steps to a CPU adapter; again with ``final_observation``.
* ``GymAdapter`` at the reference default (1 env, 100 steps with renders,
  re-seeded resets) equal to the CPU run.
* ``FrameStack(4)`` over gray_u8 and ``ObsTransform(downsample2x)`` over
  u32, 4096 envs x 32 steps, the first 256 envs equal to the CPU's.
* ``record_episode`` camera and top views of the reference default and
  MultiPlayerRoom: frames and GIF bytes equal to the CPU's.
* ``WebPlaySession`` PNG frames and statuses through a key script equal to
  the CPU's; ``utils/debug``; ``examples/profile_step`` and
  ``examples/profile_ppo`` on the card.

``python -m pytest tests/test_torch_card_tools.py -m cuda --noconftest``;
this file imports no JAX.
"""

import numpy as np
import pytest
import torch

import raycastworlds_tpu_torch as rt
from raycastworlds_tpu_torch.utils import profiling
from test_torch_card_paths import (  # noqa: F401 (cuda_device is a fixture)
    STEPS, assert_launched, cuda_device, launch_counts, multi_player_cfg, same_state,
)

SEED = 0
ENVS = 4096           # flagship_single_room_4096
CPU_ENVS = 256        # the card's first envs, held against a CPU run of these envs
CPU_STEPS = 16
WEB_KEYS = "wwawdsvrw"


def flagship_cfg(**kw):
    """The JAX bench row flagship_single_room_4096: SingleRoom, 64 rays x 64
    px, camera_u32 under ``auto`` (the crossing cast kernel)."""
    return rt.EnvConfig(num_rays=64, height_camera_view_pu=64, **kw)


def assert_same_arrays(got, want) -> None:
    """Two numpy arrays, equal bit for bit with the same dtype and shape."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=got.dtype.kind == "f")


def assert_same_five_tuple(got, want) -> None:
    """(obs, reward, terminated, truncated, info) of two adapter steps."""
    for g, w in zip(got[:4], want[:4]):
        assert type(g) is type(w)
        assert_same_arrays(g, w)
    assert sorted(got[4]) == sorted(want[4])
    for k in want[4]:
        assert_same_arrays(got[4][k], want[4][k])


@pytest.mark.cuda
@pytest.mark.parametrize("final", [False, True], ids=["plain", "final_observation"])
def test_vector_adapter_equals_env_and_cpu(cuda_device, final):
    from raycastworlds_tpu_torch.utils import to_numpy

    cfg = flagship_cfg()
    actions = np.random.default_rng(SEED).integers(0, 4, size=(STEPS, ENVS)).astype(np.int32)
    adapter = rt.GymVectorAdapter(rt.SingleRoom(cfg), ENVS, final_observation=final,
                                  device=cuda_device)
    before = launch_counts()
    obs0, _ = adapter.reset(seed=SEED)
    outs = [adapter.step(a) for a in actions]
    assert_launched(before, "crossing_cast", 1 + (2 if final else 1) * STEPS)
    # the same keys through Env on the card
    env = rt.Env(rt.SingleRoom(cfg), ENVS, device=cuda_device, final_obs_in_info=final)
    state, obs = env.reset(rt.rng.split(rt.rng.PRNGKey(SEED))[1])
    assert_same_arrays(obs0, to_numpy(obs))
    for a, got in zip(actions, outs):
        res = env.step(state, torch.from_numpy(a))
        state = res.state
        info = {k: to_numpy(v) for k, v in res.info.items()}
        assert_same_five_tuple(got, (to_numpy(res.obs), to_numpy(res.reward),
                                     info["terminated"], info["truncated"], info))
        if final:
            done = got[2] | got[3]
            assert_same_arrays(got[4]["final_observation"][~done], got[0][~done])
    assert same_state(adapter._state, state)
    cpu = rt.GymVectorAdapter(rt.SingleRoom(cfg), CPU_ENVS, final_observation=final,
                              device="cpu")
    assert_same_arrays(obs0[:CPU_ENVS], cpu.reset(seed=SEED)[0])
    for t in range(CPU_STEPS):
        obs, reward, term, trunc, info = outs[t]
        n = CPU_ENVS
        assert_same_five_tuple((obs[:n], reward[:n], term[:n], trunc[:n],
                                {k: v[:n] for k, v in info.items()}),
                               cpu.step(actions[t, :n]))


@pytest.mark.cuda
def test_gym_adapter_equals_cpu(cuda_device, steps=100):
    """The reference default at one env, max_episode_steps=50: ``steps``
    steps with a render after each, re-seeded on every episode end."""
    actions = np.random.default_rng(SEED + 1).integers(0, 4, size=steps)

    def drive(dev):
        adapter = rt.GymAdapter(rt.SingleRoom(rt.EnvConfig()), max_episode_steps=50,
                                device=dev)
        out, resets = [adapter.reset(seed=SEED)[0]], 0
        for t, a in enumerate(actions):
            step = adapter.step(int(a))
            out += [step, adapter.render()]
            if step[2] or step[3]:
                out.append(adapter.reset(seed=t + 1 if step[2] else t + 100)[0])
                resets += 1
        return out, resets

    before = launch_counts()
    card, resets = drive(cuda_device)
    assert_launched(before, "crossing_cast", 1 + 2 * steps + resets)
    cpu, cpu_resets = drive("cpu")
    assert len(card) == len(cpu) and resets == cpu_resets > 0
    for g, w in zip(card, cpu):
        (assert_same_five_tuple if isinstance(w, tuple) else assert_same_arrays)(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["frame_stack", "downsample"])
def test_wrappers_equal_cpu(cuda_device, wrapper, steps=32):
    """FrameStack(n_stack=4) over the PPO throughput row's env (camera_gray_u8)
    and ObsTransform(downsample2x) over the flagship u32 env, 4096 envs:
    the first CPU_ENVS envs' obs, reward and done equal a CPU run's."""
    from raycastworlds_tpu_torch.utils import to_numpy
    from raycastworlds_tpu_torch.wrappers import downsample2x

    actions = np.random.default_rng(SEED + 2).integers(0, 4, size=(steps, ENVS)).astype(np.int32)

    def drive(dev, n):
        if wrapper == "frame_stack":
            w = rt.FrameStack(rt.Env(rt.SingleRoom(flagship_cfg(obs_type="camera_gray_u8")), n,
                                     device=dev), n_stack=4)
        else:
            w = rt.ObsTransform(rt.Env(rt.SingleRoom(flagship_cfg()), n, device=dev),
                                downsample2x)
        state, obs = w.reset(rt.rng.PRNGKey(SEED))
        out = [to_numpy(obs[:CPU_ENVS])]
        for a in actions[:, :n]:
            res = w.step(state, torch.from_numpy(a))
            state = res.state
            out += [to_numpy(x[:CPU_ENVS]) for x in (res.obs, res.reward, res.done)]
        return out

    before = launch_counts()
    card = drive(cuda_device, ENVS)
    assert_launched(before, "crossing_cast", 1 + steps)
    for g, c in zip(card, drive("cpu", CPU_ENVS)):
        assert_same_arrays(g, c)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["camera", "top"])
@pytest.mark.parametrize("family", ["SingleRoom", "MultiPlayerRoom"])
def test_record_episode_equals_cpu(cuda_device, family, view, tmp_path, steps=32):
    """``record_episode`` (2 envs) at the reference default and at
    MultiPlayerRoom's main-path config: frames equal to the CPU's, and the
    GIFs written from both byte-equal (the 256 x 512 views keep every 8th
    frame, to bound the writer's time)."""
    from raycastworlds_tpu_torch.utils import video

    game = (rt.SingleRoom(rt.EnvConfig()) if family == "SingleRoom"
            else rt.MultiPlayerRoom(multi_player_cfg()))

    def record(dev):
        env = rt.Env(game, num_envs=2, device=dev)
        return video.record_episode(env, rt.rng.PRNGKey(SEED), steps=steps, view=view)

    before = launch_counts()
    card = record(cuda_device)
    assert_launched(before, "crossing_cast", 2 + 2 * steps)
    cpu = record("cpu")
    assert_same_arrays(card, cpu)
    frames = {"card": card, "cpu": cpu}
    if card.ndim == 4:  # one player's frames of MultiPlayerRoom's cameras
        frames = {k: v[:, 0] for k, v in frames.items()}
    every = 8 if card.shape[-2] * card.shape[-1] > 64 * 64 else 1
    gifs = []
    for tag, f in frames.items():
        video.save_gif(str(tmp_path / f"{tag}.gif"), f[::every], fps=8)
        gifs.append((tmp_path / f"{tag}.gif").read_bytes())
    assert gifs[0] == gifs[1]


@pytest.mark.cuda
def test_web_session_equals_cpu(cuda_device):
    """WebPlaySession (the viewer's default env) through WEB_KEYS: every
    ``frame_png()`` and status byte-equal to a CPU session's."""
    from raycastworlds_tpu_torch.utils import webviewer

    def drive(dev):
        session = webviewer.WebPlaySession(seed=SEED, device=dev)
        out = [session.frame_png(), session.status()]
        for ch in WEB_KEYS:
            out += [session.handle_key(ch), session.frame_png()]
        return out

    before = launch_counts()
    card = drive(cuda_device)
    # reset and first frame, then a step and a frame per move key, a frame
    # for "v", a reset and a frame for "r"
    moves = sum(ch in "wsad" for ch in WEB_KEYS)
    assert_launched(before, "crossing_cast",
                    2 + 2 * moves + WEB_KEYS.count("v") + 2 * WEB_KEYS.count("r"))
    assert card == drive("cpu")


@pytest.mark.cuda
def test_debug_checks_on_the_card(cuda_device):
    """``validate_state`` passes on a stepped flagship state, ``checked(
    env.step)`` reports no error there, and a state with one NaN position
    throws."""
    from raycastworlds_tpu_torch.utils import debug

    cfg = flagship_cfg()
    env = rt.Env(rt.SingleRoom(cfg), ENVS, device=cuda_device)
    state, _ = env.reset(rt.rng.PRNGKey(SEED))
    for t in range(4):
        state = env.step(state, env.sample_action(rt.rng.PRNGKey(SEED + t))).state
    debug.validate_state(cfg, state)
    actions = torch.zeros(ENVS, dtype=torch.int32, device=cuda_device)
    before = launch_counts()
    err, res = debug.checked(env.step)(state, actions)
    assert_launched(before, "crossing_cast", 1)
    assert err.get() is None
    pos = res.state.pos_wu.clone()
    pos[7, 0] = float("nan")
    err, _ = debug.checked(lambda s: s.replace(pos_wu=pos))(res.state)
    with pytest.raises(RuntimeError, match="pos_wu: 1 non-finite"):
        err.throw()


@pytest.mark.cuda
def test_profile_step_example(cuda_device, tmp_path, steps=16):
    """``examples/profile_step`` at flagship_single_room_4096: its JSON
    line on the card, ``crossing_cast_kernel`` in its trace at most once a
    step, threefry launched 8 times a step by the reset."""
    from raycastworlds_tpu_torch.examples import profile_step

    path = str(tmp_path / "profile_step")
    before = launch_counts()
    threefry = profiling.total("kernel_launches.threefry")
    out = profile_step.main(["--num-envs", str(ENVS), "--steps", str(steps), "--top", "15",
                             "--trace-dir", path, "--device", str(cuda_device)])
    # the reset's observation, then the warm-up, timed and profiled runs
    assert_launched(before, "crossing_cast", 1 + 3 * steps)
    # the env's reset (split, then reset_batch's 8 hashes), then for each of
    # the 3 runs its actions' randint (3 hashes) and 8 a step in the reset
    assert profiling.total("kernel_launches.threefry") - threefry == 1 + 8 + 3 * (3 + 8 * steps)
    _, calls, _ = profiling.aggregate_trace(path)
    assert 0 < sum(c for k, c in calls.items() if "crossing_cast_kernel" in k) <= steps
    assert out["device"].startswith("cuda") and out["device_ms_per_step"] > 0
    within = {k: v["ms_per_step"] for k, v in out["within"].items()}
    assert 0 < within["threefry"] < within["reset_batch"]


@pytest.mark.cuda
def test_profile_ppo_example(cuda_device):
    """``examples/profile_ppo`` at ppo_train_step_mlp_bf16 (camera_gray,
    2048 envs, mlp hidden 256 bfloat16, 2 epochs), one call per phase."""
    from raycastworlds_tpu_torch.examples import profile_ppo

    before = launch_counts()
    out = profile_ppo.main([
        "--num-envs", "2048", "--rollout-steps", str(STEPS), "--obs", "camera_gray",
        "--hidden", "256", "--dtype", "bfloat16", "--trunk", "mlp", "--epochs", "2",
        "--reps", "1", "--device", str(cuda_device)])
    # init's reset; full and rollout: warm-up + 1, rollout + bootstrap; the
    # captured rollout; env_only: warm-up + 1, no bootstrap; infer_only's obs
    full = STEPS + 2
    assert_launched(before, "crossing_cast",
                    1 + 2 * full + 2 * full + full + 2 * (STEPS + 1) + 1)
    assert all(v > 0 for v in out["times_ms"].values())
