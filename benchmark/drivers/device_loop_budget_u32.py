"""The on-device closed loop of ``device_loop_budget`` for 0x00RRGGBB
frames: ``Env.step`` with budgeted auto-reset (the configuration's
top-level ``reset_budget``), every uint32 camera observation consumed on
the device by one read of its int32 view, as ``device_loop`` reads it (its
per-column sums, added into a running total per env and column).  The
check also gets each env's wall map and whether it waits for a reset."""

from __future__ import annotations

import torch

from . import device_loop, device_loop_budget


class Driver(device_loop_budget.Driver):
    _consume = device_loop.Driver._consume

    def outputs(self) -> dict:
        out = super().outputs()
        out["last_obs"] = self.obs.view(torch.int32)
        return out
