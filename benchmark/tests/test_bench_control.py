"""The control comes out not correct: the plain reference put in the
program's place and computed in bfloat16, the precision below the
configuration's float32.  The same reference in float32 comes out correct.
(On the card at the cells' own sizes: ``benchmark/control.py``.)"""

import pytest
import torch

from benchmark import control

CELLS = ["single_room_64.device_loop_4096", "single_room_64.host_loop_4096",
         "single_room_512x256.device_loop_4096"]


def run(cell, dtype):
    return control.run(cell, 3 * 2**31 + 1, 0.5, device="cpu", dtype=dtype,
                       overrides={"traffic": {"num_envs": 12, "warmup_steps": 2}})


@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_fails(cell):
    r = run(cell, torch.bfloat16)
    assert r["correct"] is False
    assert max(c["value"] for c in r["checks"].values()) > 0


@pytest.mark.parametrize("cell", CELLS[:2])
def test_float32_reference_in_place_passes(cell):
    r = run(cell, torch.float32)
    assert r["correct"] is True
