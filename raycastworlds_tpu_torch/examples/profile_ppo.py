"""Phase-level profile of the PPO train step.

    python -m raycastworlds_tpu_torch.examples.profile_ppo --num-envs 2048 --trunk mlp
    python -m raycastworlds_tpu_torch.examples.profile_ppo --device cpu --num-envs 8 \\
        --rollout-steps 4 --num-rays 16 --height-px 16 --hidden 16 --reps 1

The port of the JAX package's ``examples/profile_ppo.py``.  What an RL
user sustains is the whole train step; this script splits one PPO
configuration into phases and ablations so the time goes somewhere
nameable:

  full          -- ``PPOTrainer.train_step``
  rollout       -- ``_rollout_phase`` alone (env + inference + GAE)
  update        -- ``_update_phase`` alone (epochs x minibatches on a
                   captured rollout)
  env_only      -- ``rollout_policy`` with a constant action (no network)
  infer_only    -- T policy inferences on a fixed obs batch (no env)
  update_1ep    -- the update with num_epochs=1 (epoch-count scaling)
  update_noshuf -- the update with each permutation replaced by the
                   identity (isolates the [T*B]-row gather's cost)
  grad_mb       -- one minibatch's loss forward and backward

Each is the median of ``--reps`` timed calls after one warm-up, on the
host clock between device synchronisations, each ending on a host read of
its result.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=2048)
    p.add_argument("--rollout-steps", type=int, default=64)
    p.add_argument("--num-rays", type=int, default=64)
    p.add_argument("--height-px", type=int, default=64)
    p.add_argument("--obs", type=str, default="camera_gray")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--trunk", type=str, default="patch", choices=["conv", "patch", "mlp"])
    p.add_argument("--epochs", type=int, default=0,
                   help="override PPO epochs (0 = PPOConfig default)")
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.parallel.ppo import (
        PPOConfig, PPOTrainer, make_policy_fn, ppo_loss)
    from raycastworlds_tpu_torch.parallel.rollout import rollout_policy

    cfg = rt.EnvConfig(num_rays=args.num_rays, height_camera_view_pu=args.height_px,
                       obs_type=args.obs)
    env = rt.Env(rt.SingleRoom(cfg), num_envs=args.num_envs, device=args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    epochs = {"num_epochs": args.epochs} if args.epochs else {}

    def trainer_of(**kw):
        return PPOTrainer(env, PPOConfig(rollout_steps=args.rollout_steps, **kw),
                          hidden=args.hidden, dtype=dtype, trunk=args.trunk)

    def sync():
        if env.device.type == "cuda":
            torch.cuda.synchronize(env.device)

    def timeit(fn, *a):
        """Median seconds of ``fn(*a)`` over ``--reps`` calls after a
        warm-up; each call ends on a host read of its result."""
        float(fn(*a))
        times = []
        for _ in range(args.reps):
            sync()
            t0 = time.perf_counter()
            float(fn(*a))
            times.append(time.perf_counter() - t0)
        return sorted(times)[len(times) // 2]

    trainer = trainer_of(**epochs)
    ts = trainer.init(rt.rng.PRNGKey(0))
    steps = args.num_envs * args.rollout_steps
    k = rt.rng.PRNGKey(1, env.device)
    res = {"full": timeit(lambda s: trainer.train_step(s)[1]["loss"], ts)}

    with torch.no_grad():
        res["rollout"] = timeit(
            lambda s, k: trainer._rollout_phase(s, k)[4]["reward_per_step"], ts, k)
        # a captured rollout for the update phase's timing
        _, traj, adv, target, _ = trainer._rollout_phase(ts, k)

    def update(tr):
        return lambda: tr._update_phase(ts.params, ts.opt_state, k, traj, adv, target)[2]["loss"]

    res["update"] = timeit(update(trainer))

    def const_policy(obs, key):
        b = obs.shape[0]
        zeros = torch.zeros(b, dtype=torch.float32, device=obs.device)
        return torch.zeros(b, dtype=torch.int32, device=obs.device), zeros, zeros

    with torch.no_grad():
        res["env_only"] = timeit(lambda s: rollout_policy(
            env, const_policy, s, k, args.rollout_steps)[1].reward.sum(), ts.env_state)

        # T chained policy evaluations on one observation batch (the value
        # sums carry the chain)
        obs0 = env.game.observe_batch(ts.env_state)
        policy = make_policy_fn(trainer.net, cfg, ts.params)

        def infer_loop():
            acc = torch.zeros((), dtype=torch.float32, device=env.device)
            for kk in rt.rng.split(k, args.rollout_steps):
                acc = acc + policy(obs0, kk)[2].sum()
            return acc

        res["infer_only"] = timeit(infer_loop)

    res["update_1ep"] = timeit(update(trainer_of(num_epochs=1)))

    permutation = rt.rng.permutation
    rt.rng.permutation = lambda key, n: torch.arange(n, device=key.device)
    try:
        res["update_noshuf"] = timeit(update(trainer))
    finally:
        rt.rng.permutation = permutation

    n = args.rollout_steps * args.num_envs
    mb = n // trainer.cfg.num_minibatches

    def first(x):
        return x.reshape((n,) + x.shape[2:])[:mb]

    batch = {"obs": first(traj.obs), "action": first(traj.action),
             "log_prob": first(traj.log_prob), "advantage": first(adv),
             "target": first(target)}

    def grad_mb():
        params = {name: v.detach().requires_grad_(True) for name, v in ts.params.items()}
        loss, _ = ppo_loss(trainer.net, cfg, trainer.cfg, params, batch)
        torch.autograd.grad(loss, list(params.values()))
        return loss.detach()

    res["grad_mb"] = timeit(grad_mb)

    n_grad_steps = trainer.cfg.num_epochs * trainer.cfg.num_minibatches
    out = {
        "config": vars(args),
        "device": str(env.device),
        "env_steps_per_update": steps,
        "times_ms": {name: v * 1e3 for name, v in res.items()},
        "sps": {name: steps / v for name, v in res.items()
                if name in ("full", "rollout", "update", "env_only")},
        "derived_ms": {
            "inference_in_rollout": 1e3 * (res["rollout"] - res["env_only"]),
            "shuffle_gather": 1e3 * (res["update"] - res["update_noshuf"]),
            "grad_steps_total_est": 1e3 * n_grad_steps * res["grad_mb"],
            "phase_sum_vs_full": 1e3 * (res["rollout"] + res["update"] - res["full"]),
        },
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
