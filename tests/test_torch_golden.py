"""The port reproduces the JAX package's pinned golden frame
(tests/data/golden_frames.npz, key "single_room") on the CPU, exactly.

The frame follows tests/test_golden_images.py: for the first of the seeds
(1234, 7, 42, 99) whose frame has at least 3 colours, reset, then actions
2, 0, 3, then observe.  chip_smoke.py repeats this on the card through the
CUDA kernel.
"""

import os

import numpy as np
import pytest
import torch

import raycastworlds_tpu_torch as rt

_DATA = os.path.join(os.path.dirname(__file__), "data", "golden_frames.npz")


def _frame(game: rt.SingleRoom, device="cpu") -> np.ndarray:
    for seed in (1234, 7, 42, 99):
        state = game.reset_batch(rt.rng.PRNGKey(seed, device)[None])
        for a in (2, 0, 3):
            state = game.step_batch(
                state, torch.full((1,), a, dtype=torch.int32, device=device)
            )
        frame = game.observe_batch(state)[0].cpu().numpy()
        if len(np.unique(frame)) >= 3:
            return frame
    raise AssertionError("no structural snapshot found")


@pytest.mark.parametrize("backend", ["auto", "crossing_kernel"])
def test_golden_single_room(backend):
    golden = np.load(_DATA)["single_room"]
    game = rt.SingleRoom(rt.EnvConfig(
        num_rays=64, height_camera_view_pu=48, raycast_backend=backend
    ))
    frame = _frame(game)
    assert frame.dtype == np.uint32 and frame.shape == golden.shape
    np.testing.assert_array_equal(frame, golden)
