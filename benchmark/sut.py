"""The system under test: the port, built from a configuration file."""

from __future__ import annotations

from typing import Dict


class Port:
    """The configuration's world family of ``raycastworlds_tpu_torch``, and
    the entry points the drivers step it through."""

    def __init__(self, config: Dict):
        import raycastworlds_tpu_torch as rt

        self.rt = rt
        cfg = getattr(rt, config["config_class"])(**config["env"])
        self.game = getattr(rt, config["family"])(cfg)
        self.num_actions = self.game.num_actions

    def env(self, num_envs: int, device):
        """The batched auto-resetting ``Env`` (dense reset)."""
        return self.rt.Env(self.game, num_envs=num_envs, device=device)

    def adapter(self, num_envs: int, device):
        """The gymnasium-style vector adapter, numpy in and out."""
        return self.rt.GymVectorAdapter(self.game, num_envs, reset_budget=0,
                                        device=device)
