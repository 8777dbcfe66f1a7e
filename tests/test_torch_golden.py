"""The port reproduces the JAX package's pinned golden frames
(tests/data/golden_frames.npz) on the CPU, exactly: every key, the
checker, brick and xor wall textures included.  The jitted JAX package
computes the texture's cross coordinate and xor factor with FMAs where the
port rounds twice; no pixel of these frames moves for it.

The frame follows tests/test_golden_images.py: for the first of the seeds
(1234, 7, 42, 99) whose frame has at least 3 colours, reset, then actions
2, 0, 3 (for every player), then observe.
tests/test_torch_card_paths.py repeats "single_room", the three textured
keys, "multi_player" and "top_view" on the card.
"""

import os

import numpy as np
import pytest
import torch

import raycastworlds_tpu_torch as rt

_DATA = os.path.join(os.path.dirname(__file__), "data", "golden_frames.npz")


# key -> the game of tests/test_golden_images.py's case
CASES = {
    **{f"single_room_{tex}": (lambda tex=tex: rt.SingleRoom(rt.EnvConfig(
        num_rays=64, height_camera_view_pu=48, wall_texture=tex, texture_cells=8)))
       for tex in ("checker", "brick", "xor")},
    "maze": lambda: rt.Maze(rt.MazeConfig(
        height_tile_map_tu=11, width_tile_map_tu=11, num_rays=64, height_camera_view_pu=48)),
    "random_room": lambda: rt.RandomRoom(rt.RandomRoomConfig(
        height_tile_map_tu=12, width_tile_map_tu=12, num_rays=64, height_camera_view_pu=48)),
    "multi_goal": lambda: rt.MultiGoalRoom(rt.MultiGoalConfig(
        num_goals=3, num_rays=64, height_camera_view_pu=48)),
    "locked_room": lambda: rt.LockedRoom(rt.LockedRoomConfig(
        num_rays=64, height_camera_view_pu=48)),
    "dynamic_room": lambda: rt.DynamicRoom(rt.DynamicRoomConfig(
        num_blocks=3, num_rays=64, height_camera_view_pu=48)),
    "top_view": lambda: rt.SingleRoom(rt.EnvConfig(
        num_rays=32, pu_per_tu=8, obs_type="top_u32")),
    "multi_player": lambda: rt.MultiPlayerRoom(rt.MultiPlayerConfig(
        num_players=2, num_rays=64, height_camera_view_pu=48)),
}


def _frame(game, device="cpu") -> np.ndarray:
    for seed in (1234, 7, 42, 99):
        state = game.reset_batch(rt.rng.PRNGKey(seed, device)[None])
        for a in (2, 0, 3):
            state = game.step_batch(state, torch.full(
                (1,) + game.action_shape, a, dtype=torch.int32, device=device))
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


@pytest.mark.parametrize("name", list(CASES))
def test_golden_frame(name):
    golden = np.load(_DATA)[name]
    frame = _frame(CASES[name]())
    assert frame.dtype == golden.dtype and frame.shape == golden.shape
    np.testing.assert_array_equal(frame, golden)
