"""The on-device closed loop of ``device_loop`` for a world of P players:
``Env.step`` with dense auto-reset in a Python loop, one action per player
drawn on the device from the seed (int32 [B, P], P from the game's
``action_shape``), every observation [B, P, H, R] consumed on the device by
one read of its int32 view (its per-column sums, added into a running
total per env, player and column).  The check gets each env's rewards
summed over its players, and the last frames as int32 [B, P, H, R]."""

from __future__ import annotations

import torch

from . import device_loop, leaves, seed_words


class Driver(device_loop.Driver):
    def __init__(self, program, config, traffic, seed, device):
        self.device = torch.device(device)
        self.B = b = int(traffic["num_envs"])
        self.env = program.env(b, self.device)
        self.objects = {"env": self.env, "game": program.game}
        self.key = seed_words(seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed) % 2**64)
        self.pool = torch.randint(0, program.num_actions,
                                  (int(traffic["action_pool_steps"]), b)
                                  + tuple(program.game.action_shape),
                                  generator=gen, device=self.device, dtype=torch.int32)
        key = torch.tensor(self.key.astype("int64"), device=self.device)
        self.state, obs = self.env.reset(key)
        self.start = leaves(self.state)
        self.cols = torch.zeros(obs.shape[:2] + obs.shape[3:], dtype=torch.int64,
                                device=self.device)
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
        self.cols += obs.view(torch.int32).sum(dim=2, dtype=torch.int64)

    def step(self):
        res = self.env.step(self.state, self.pool[self.steps % self.pool.shape[0]])
        self.steps += 1
        self.state = res.state
        self._consume(res.obs)
        self.rewards += res.reward.sum(dim=-1, dtype=torch.float64)
        self.ends += res.done
        self.truncs += res.info["truncated"]
