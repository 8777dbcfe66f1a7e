"""The harness drives a whole run on the CPU with the timed path broken
underneath, and ``correct`` comes out false: a step that returns its state
unchanged, half of the batch left out, and an answer altered where it is
produced (one pixel, one reward).  One chip: no exchange between chips to
leave out."""

import pytest
import torch

from benchmark import harness
from benchmark.sut import Port

SMALL = {"traffic": {"num_envs": 8, "warmup_steps": 2}}


def unchanged(env, state, action, step):
    obs = env.game.observe_batch(state)
    zeros = torch.zeros(state.done.shape, dtype=torch.float32)
    info = {"truncated": state.done & False, "terminated": state.done & False,
            "terminal_t": state.t, "episode_return": state.episode_return}
    return type(step(state, action))(state, obs, zeros, state.done & False, info)


def half_batch(env, state, action, step):
    res = step(state, action)
    keep = torch.arange(state.done.shape[0]) < state.done.shape[0] // 2
    from raycastworlds_tpu_torch.state import select

    nxt = select(keep, res.state, state)
    return res._replace(state=nxt, obs=env.game.observe_batch(nxt))


def one_pixel(env, state, action, step):
    res = step(state, action)
    if int(state.t.max()) == 3:
        obs = res.obs.view(torch.int32).clone()
        obs[1, 5, 7] ^= 1
        res = res._replace(obs=obs.view(torch.uint32))
    return res


def one_reward(env, state, action, step):
    res = step(state, action)
    if int(state.t.max()) == 3:
        reward = res.reward.clone()
        reward[2] += 1.0
        res = res._replace(reward=reward)
    return res


class Faulty(Port):
    def __init__(self, config, fault):
        super().__init__(config)
        self.fault = fault

    def _break(self, e):
        step = e.step
        e.step = lambda state, action: self.fault(e, state, action, step)
        return e

    def env(self, num_envs, device):
        return self._break(super().env(num_envs, device))

    def adapter(self, num_envs, device):
        a = super().adapter(num_envs, device)
        self._break(a._env)
        return a


@pytest.mark.parametrize("fault", [unchanged, half_batch, one_pixel, one_reward])
@pytest.mark.parametrize("workload", ["single_room_64.device_loop_4096",
                                      "single_room_64.host_loop_4096",
                                      "single_room_512x256.device_loop_4096"])
def test_fault_is_caught(workload, fault):
    cell = harness.cell_of(harness.load_bench(), workload)
    program = Faulty(harness.load_config(cell["config"]), fault)
    r = harness.run(workload, 2**31 + 7, 0.5, False, t0=0.0, device="cpu",
                    program=program, overrides=SMALL)
    assert r["correct"] is False, r["checks"]


def test_sound_port_passes():
    r = harness.run("single_room_64.device_loop_4096", 2**31 + 7, 0.5, False, t0=0.0,
                    device="cpu", overrides=SMALL)
    assert r["correct"] is True
