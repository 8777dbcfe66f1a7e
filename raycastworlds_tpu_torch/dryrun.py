"""Dry runs of the port: one env step, and one train step over a mesh.

    python -m raycastworlds_tpu_torch.dryrun                          # one rank
    torchrun --nproc-per-node N -m raycastworlds_tpu_torch.dryrun     # N ranks

The port of the JAX package's ``__graft_entry__.py``:

* ``entry()`` -- a forward step of the flagship workload (batched
  SingleRoom, camera observations) and its example arguments;
* ``dryrun_multichip(n, devices)`` -- called on each of ``n`` ranks: the
  (dp, mp) mesh over them (``mp = 2`` where ``n`` is even and at least 4),
  then one ``PPOTrainer`` and one ``RecurrentPPOTrainer`` train step over
  it at 64x64 gray camera views and 64 envs per rank, with finite metrics.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from . import Env, EnvConfig, SingleRoom, rng
from .parallel import mesh as mesh_lib
from .parallel.ppo import PPOConfig, PPOTrainer
from .parallel.ppo_rnn import RecurrentPPOTrainer


def entry(device=None):
    """``(step, (state, actions))``: ``step(state, actions)`` returns the
    next state, observation, reward and done of 256 SingleRoom envs at 64
    rays x 64 px on ``device`` (the CUDA device by default)."""
    cfg = EnvConfig(num_rays=64, height_camera_view_pu=64)
    env = Env(SingleRoom(cfg), num_envs=256, device=device)
    state, _ = env.reset(rng.PRNGKey(0))
    actions = torch.zeros(256, dtype=torch.int32, device=env.device)

    def step(state, actions):
        res = env.step(state, actions)
        return res.state, res.obs, res.reward, res.done

    return step, (state, actions)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None,
                     num_rays: int = 64, height_px: int = 64) -> dict:
    """One feedforward (hidden 128) and one GRU (hidden 64) train step over
    the ``n_devices`` ranks of the process group, rollout 4, one epoch of 2
    minibatches; ``devices`` as ``make_mesh`` takes them.  Raises unless
    every metric is finite; returns both trainers' metrics as floats."""
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) on {world} ranks")
    mp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = mesh_lib.make_mesh(dp=n_devices // mp, mp=mp, devices=devices)
    cfg = EnvConfig(num_rays=num_rays, height_camera_view_pu=height_px,
                    obs_type="camera_gray")
    env = Env(SingleRoom(cfg), num_envs=64 * n_devices, mesh=mesh)
    ppo_cfg = PPOConfig(rollout_steps=4, num_epochs=1, num_minibatches=2)
    out = {}
    for name, trainer, key in (
        ("ppo", PPOTrainer(env, ppo_cfg, hidden=128, mesh=mesh), 0),
        ("gru", RecurrentPPOTrainer(env, ppo_cfg, hidden=64, mesh=mesh), 1),
    ):
        ts, metrics = trainer.train_step(trainer.init(rng.PRNGKey(key)))
        if ts.update_count != 1:
            raise RuntimeError(f"{name}: update_count {ts.update_count}")
        metrics = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in metrics.items() if not math.isfinite(v)]
        if bad:
            raise RuntimeError(f"{name}: metrics not finite: {bad}")
        out[name] = metrics
    return out


def main() -> None:
    step, args = entry()
    print("entry() OK: obs", tuple(step(*args)[1].shape))
    joins = not torch.distributed.is_initialized()
    mesh_lib.initialize_distributed()
    try:
        world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
        dryrun_multichip(world)
    finally:
        if joins and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print(f"dryrun_multichip({world}) OK")


if __name__ == "__main__":
    main()
