"""The port's demo and profile scripts, each run as ``python -m
raycastworlds_tpu_torch.examples.<name>`` and printing one JSON line:
``rollout_demo``, ``multi_player_demo``, ``profile_step`` and
``profile_ppo`` (the training entry point is ``raycastworlds_tpu_torch.train``).
Each runs on the CUDA device unless given ``--device``."""
