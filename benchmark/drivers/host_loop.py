"""The host loop of SB3- or CleanRL-style libraries: ``GymVectorAdapter``
(dense reset) stepped with numpy actions drawn from the seed, numpy arrays
back every step.  Each frame is consumed on the host by one read (its
per-column sums, modulo 2**32 as uint32 adds wrap, added into a running
total per env and column); the time of each ``step`` call is kept."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import threefry


class Driver:
    def __init__(self, program, config, traffic, seed, device):
        self.device = torch.device(device)
        self.B = b = int(traffic["num_envs"])
        self.adapter = program.adapter(b, self.device)
        self.objects = {"adapter": self.adapter, "game": getattr(program, "game", None)}
        # gymnasium's seeding contract: an int32 seed re-seeds the adapter's
        # key stream, PRNGKey(seed), whose second split resets the envs
        self.adapter_seed = int(seed) % 2**31
        self.key = threefry.split(threefry.key_of_seed(self.adapter_seed), 2)[1]
        self.pool = np.random.default_rng(int(seed)).integers(
            0, program.num_actions, size=(int(traffic["action_pool_steps"]), b),
            dtype=np.int32)
        obs, _ = self.adapter.reset(seed=self.adapter_seed)
        self.cols = np.zeros((b, obs.shape[-1]), dtype=np.int64)
        self.rewards = np.zeros(b, dtype=np.float64)
        self.ends = np.zeros(b, dtype=np.int64)
        self.truncs = np.zeros(b, dtype=np.int64)
        self._consume(obs)
        self.steps = 0
        self.step_s = 0.0
        for _ in range(int(traffic["warmup_steps"])):
            self.step()

    def _consume(self, obs):
        self.obs = obs
        self.cols += obs.view(np.uint32).sum(axis=1, dtype=np.uint32)

    def step(self):
        action = self.pool[self.steps % self.pool.shape[0]]
        start = time.perf_counter()
        obs, reward, terminated, truncated, info = self.adapter.step(action)
        self.step_s = time.perf_counter() - start
        self.steps += 1
        self._consume(obs)
        self.rewards += reward
        self.ends += terminated | truncated
        self.truncs += truncated
        self.info = info

    def sync(self):
        pass  # every step ends on the host copies of its arrays

    def window(self, seconds: float) -> dict:
        first = self.steps
        times = []
        start = time.perf_counter()
        deadline = start + seconds
        while True:
            self.step()
            times.append(self.step_s)
            if time.perf_counter() >= deadline:
                break
        wall = time.perf_counter() - start
        n = self.steps - first
        return {"attempted": n, "env_steps_per_s": n * self.B / wall,
                "step_ms_p95": float(np.percentile(times, 95)) * 1e3}

    def outputs(self) -> dict:
        return {
            "num_envs": self.B, "key": self.key, "pool": torch.from_numpy(self.pool),
            "steps": self.steps, "cols": self.cols, "col_mod": 2**32,
            "rewards": self.rewards, "ends": self.ends, "truncs": self.truncs,
            "start": None,
            "end": {"terminal_t": self.info["terminal_t"],
                    "terminal_return": self.info["episode_return"]},
            "last_obs": torch.from_numpy(self.obs.view(np.int32)),
        }
