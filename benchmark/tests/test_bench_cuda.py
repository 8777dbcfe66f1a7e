"""On the card: a small run of each cell's driver through the port's CUDA
kernel, correct, with the traced metrics read from the device trace."""

import pytest
import torch

from benchmark import harness

SMALL = {"traffic": {"num_envs": 64, "warmup_steps": 2}}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["single_room_64.device_loop_4096",
                                      "single_room_64.host_loop_4096"])
def test_small_run_on_the_card(cuda_device, workload):
    r = harness.run(workload, 2**32 + 11, 1.0, True, t0=0.0, device=cuda_device,
                    overrides=SMALL)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["busy_s"] > 0
    for name in ("launches_per_step", "reset_device_ms", "device_idle_share",
                 "crossing_cast_roofline", "render_roofline"):
        assert name in r["metrics"], name
    for name in ("crossing_cast_roofline", "render_roofline"):
        assert 0 < r["metrics"][name]["value"] <= 105
