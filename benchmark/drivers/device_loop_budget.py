"""The on-device closed loop of ``device_loop`` under a reset budget:
``Env.step`` with budgeted auto-reset (the configuration's top-level
``reset_budget``) in a Python loop, actions drawn on the device from the
seed, every RGB observation consumed on the device by one read (its
per-column, per-channel sums, added into a running total per env, column
and channel).  The check also gets each env's wall map and whether it
waits for a reset."""

from __future__ import annotations

import torch

from . import device_loop, host, leaves, seed_words


class Driver(device_loop.Driver):
    def __init__(self, program, config, traffic, seed, device):
        self.device = torch.device(device)
        self.B = b = int(traffic["num_envs"])
        self.env = program.rt.Env(program.game, b, device=self.device,
                                  reset_budget=int(config["reset_budget"]))
        self.objects = {"env": self.env, "game": program.game}
        self.key = seed_words(seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed) % 2**64)
        self.pool = torch.randint(0, program.num_actions,
                                  (int(traffic["action_pool_steps"]), b),
                                  generator=gen, device=self.device, dtype=torch.int32)
        key = torch.tensor(self.key.astype("int64"), device=self.device)
        self.state, obs = self.env.reset(key)
        self.start = leaves(self.state)
        self.cols = torch.zeros((b,) + obs.shape[2:], dtype=torch.int64, device=self.device)
        self.rewards = torch.zeros(b, dtype=torch.float64, device=self.device)
        self.ends = torch.zeros(b, dtype=torch.int64, device=self.device)
        self.truncs = torch.zeros(b, dtype=torch.int64, device=self.device)
        self._consume(obs)
        self.steps = 0
        for _ in range(int(traffic["warmup_steps"])):
            self.step()
        self.sync()

    def _consume(self, obs):
        self.obs = obs
        self.cols += obs.sum(dim=1, dtype=torch.int64)

    def outputs(self) -> dict:
        end = leaves(self.state)
        end["wall_map"] = host(self.state.wall_map)
        end["pending_reset"] = host(self.state.pending_reset)
        return {
            "num_envs": self.B, "key": self.key, "pool": self.pool, "steps": self.steps,
            "cols": host(self.cols), "col_mod": None, "rewards": host(self.rewards),
            "ends": host(self.ends), "truncs": host(self.truncs),
            "start": self.start, "end": end, "last_obs": self.obs,
        }
