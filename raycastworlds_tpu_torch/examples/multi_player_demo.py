"""MultiPlayerRoom walkthrough: P players, per-player sprite cameras, one
shared goal.  Writes each player's camera frame and the bird's-eye view as
PNGs, then rolls a shared-policy random episode and reports per-player
returns.

    python -m raycastworlds_tpu_torch.examples.multi_player_demo --out frames/
    python -m raycastworlds_tpu_torch.examples.multi_player_demo --players 3 --steps 200

The port of the JAX package's ``examples/multi_player_demo.py``.  No display
needed: frames are plain PNGs (``utils/viewer.save_png``).  Prints one JSON
line at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--players", type=int, default=2)
    p.add_argument("--num-envs", type=int, default=4)
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--num-rays", type=int, default=96)
    p.add_argument("--height-px", type=int, default=96)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str,
                   default=os.path.join(tempfile.gettempdir(), "multi_player_demo"))
    p.add_argument("--render", type=str, default="sprite", choices=["sprite", "block"])
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    import numpy as np

    import raycastworlds_tpu_torch as rt
    from raycastworlds_tpu_torch.utils import to_numpy
    from raycastworlds_tpu_torch.utils.viewer import save_png

    cfg = rt.MultiPlayerConfig(
        num_players=args.players,
        num_rays=args.num_rays,
        height_camera_view_pu=args.height_px,
        player_render=args.render,
    )
    env = rt.Env(rt.MultiPlayerRoom(cfg), num_envs=args.num_envs, device=args.device)
    state, obs = env.reset(rt.rng.PRNGKey(args.seed))

    os.makedirs(args.out, exist_ok=True)
    cams = to_numpy(env.camera_view(state)[0])        # [P, H, R] u32
    for k in range(args.players):
        save_png(os.path.join(args.out, f"player{k}_camera.png"), cams[k])
    save_png(os.path.join(args.out, "top_view.png"), env.top_view(state)[0])

    key = rt.rng.PRNGKey(args.seed + 1)
    per_player = np.zeros(args.players, np.float64)
    episodes = 0
    for _ in range(args.steps):
        key, k_act = rt.rng.split(key).unbind(0)
        res = env.step(state, env.sample_action(k_act))
        state = res.state
        per_player += to_numpy(res.reward).sum(axis=0)
        episodes += int(res.done.sum())
    out = {
        "players": args.players,
        "num_envs": args.num_envs,
        "steps": args.steps,
        "per_player_return": [round(float(x), 3) for x in per_player],
        "episodes_finished": episodes,
        "frames_dir": args.out,
        "render": args.render,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
