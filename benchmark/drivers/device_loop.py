"""The on-device closed loop of an RL rollout: ``Env.step`` with dense
auto-reset in a Python loop, actions drawn on the device from the seed,
every observation consumed on the device by one read (its per-column sums,
added into a running total per env and column)."""

from __future__ import annotations

import time

import torch

from . import host, leaves, seed_words


class Driver:
    def __init__(self, program, config, traffic, seed, device):
        self.device = torch.device(device)
        self.B = b = int(traffic["num_envs"])
        self.env = program.env(b, self.device)
        self.objects = {"env": self.env, "game": getattr(program, "game", None)}
        self.key = seed_words(seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed) % 2**64)
        self.pool = torch.randint(0, program.num_actions,
                                  (int(traffic["action_pool_steps"]), b),
                                  generator=gen, device=self.device, dtype=torch.int32)
        key = torch.tensor(self.key.astype("int64"), device=self.device)
        self.state, obs = self.env.reset(key)
        self.start = leaves(self.state)
        rays = obs.shape[-1]
        self.cols = torch.zeros((b, rays), dtype=torch.int64, device=self.device)
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
        self.cols += obs.view(torch.int32).sum(dim=1, dtype=torch.int64)

    def step(self):
        res = self.env.step(self.state, self.pool[self.steps % self.pool.shape[0]])
        self.steps += 1
        self.state = res.state
        self._consume(res.obs)
        self.rewards += res.reward
        self.ends += res.done
        self.truncs += res.info["truncated"]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        """Steps until ``seconds`` have passed on the host clock; the window
        ends on a host read that waits for the device."""
        first = self.steps
        start = time.perf_counter()
        deadline = start + seconds
        while True:
            self.step()
            if time.perf_counter() >= deadline:
                break
        int(self.ends.sum())
        wall = time.perf_counter() - start
        n = self.steps - first
        return {"attempted": n, "env_steps_per_s": n * self.B / wall}

    def outputs(self) -> dict:
        return {
            "num_envs": self.B, "key": self.key, "pool": self.pool, "steps": self.steps,
            "cols": host(self.cols), "col_mod": None, "rewards": host(self.rewards),
            "ends": host(self.ends), "truncs": host(self.truncs),
            "start": self.start, "end": leaves(self.state),
            "last_obs": self.obs.view(torch.int32),
        }
