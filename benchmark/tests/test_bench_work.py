"""The roofline yardstick's counts at each cell's shapes."""

import pytest
import torch

from benchmark import harness, roofline
from benchmark.reference import single_room, threefry


def test_cast_bytes_at_the_cells():
    # [4096 envs, 512 rays], 8x16 map: 4 words + 12 pose bytes per env,
    # 16 bytes of hit per ray
    nbytes, ops = roofline.cast_work(4096, 512, 8, 16, 0)
    assert nbytes == 4096 * (16 + 12) + 4096 * 512 * 16 == 33669120
    assert ops == 0
    # the port's smoke counted the wrapper's arguments (the ray fan too):
    # 0.0151 ms at [4096, 512], 0.0019 ms at [4096, 64]; from the shapes
    assert roofline.bound_s(nbytes, ops) * 1e3 == pytest.approx(0.010050, abs=1e-6)
    small, _ = roofline.cast_work(4096, 64, 8, 16, 0)
    assert roofline.bound_s(small, 0) * 1e3 == pytest.approx(0.0012863, abs=1e-6)
    big, _ = roofline.cast_work(32768, 64, 8, 16, 0)
    assert big == 8 * small


def test_render_work_at_the_cells():
    nbytes, ops = roofline.render_work(4096, 512, 256)
    assert nbytes == 4096 * 512 * 256 * 4 + 4096 * 512 * 16
    assert ops == 2 * 4096 * 512 * 256
    assert roofline.bound_s(nbytes, ops) == nbytes / roofline.HBM_BYTES_PER_S


def test_bound_by_operations():
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 1) == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["single_room_64", "single_room_512x256"])
def test_crossings_count_grid_lines(name):
    env = harness.load_config(name)["env"]
    w = single_room.World(env, 8, "cpu")
    w.reset(threefry.split(threefry.key_of_seed(5), 8))
    hit, _, _, _ = w.cast()
    n = w.crossings()
    assert n.shape == (8,)
    # every ray leaves its tile and stops inside the room
    assert bool((n >= env["num_rays"]).all())
    assert bool((n <= env["num_rays"] * (env["height_tile_map_tu"]
                                         + env["width_tile_map_tu"])).all())
    start = torch.floor(w.pos).long()[:, None, :]
    assert torch.equal(n, (hit - start).abs().sum(dim=(1, 2)))
