"""Batched, auto-resetting environment API.

    env = Env(SingleRoom(EnvConfig()), num_envs=1024)   # on the CUDA device
    state, obs = env.reset(rng.PRNGKey(0))
    state, obs, reward, done, info = env.step(state, actions)

``device`` defaults to ``"cuda"``; without a CUDA device the constructor
raises, and ``device="cpu"`` runs the plain PyTorch versions on the CPU.

With ``auto_reset=True`` (default) finished envs are re-initialized inside
the same step: the returned ``reward``/``done`` describe the finishing
transition while ``obs``/``state`` already belong to the next episode.
Resets are dense by default: every step computes a fresh reset for every env
from its own key and selects it where the episode ended, which keeps
trajectories reproducible per env.  ``reset_budget=K`` resets at most K
envs per step instead (see :meth:`Env._budgeted_reset`).

With ``mesh=`` (``parallel/mesh.py``) ``num_envs`` stays the global batch
and this rank holds and steps only its dp slice of the rows
(``Env.shard``), on the mesh's device: its keys, actions and resets are
those rows of the one-process run, so the ranks' states together are the
one-process state bit for bit.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, NamedTuple, Optional, Tuple

import torch

from . import rng
from .models.base import Game
from .state import EnvState, default_device, select
from .utils import profiling

if TYPE_CHECKING:
    from .parallel.mesh import Mesh


class StepResult(NamedTuple):
    state: EnvState
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    info: Dict[str, torch.Tensor]


class Space(NamedTuple):
    """Minimal space descriptor (no gym dependency)."""

    shape: Tuple[int, ...]
    dtype: Any
    n: Optional[int] = None  # discrete cardinality, None for boxes


_OBS_DTYPES = {
    "camera_u32": torch.uint32,
    "camera_rgb": torch.uint8,
    "camera_gray": torch.float32,
    "camera_pal8": torch.uint8,
    "camera_gray_u8": torch.uint8,
    "depth": torch.float32,
    "tile_grid": torch.int32,
    "top_u32": torch.uint32,
    "top_rgb": torch.uint8,
}


class Env:
    """Batched auto-resetting environment on one ``device``."""

    def __init__(
        self,
        game: Game,
        num_envs: int = 1,
        auto_reset: bool = True,
        device=None,
        final_obs_in_info: bool = False,
        *,
        jit: bool = True,
        donate: bool = False,
        reset_budget: int = 0,
        mesh: Optional[Mesh] = None,
    ):
        """``device=None`` is the CUDA device, and raises where there is
        none: the CPU is only ever asked for, never fallen back to.
        ``jit`` and ``donate`` have no counterpart in eager PyTorch and are
        ignored.  ``final_obs_in_info=True`` also renders the post-step,
        pre-reset state into ``info["final_observation"]`` (the terminal
        observation the auto-reset otherwise discards), at the cost of a
        second cast and render per step.

        ``reset_budget > 0`` (clamped to ``num_envs``) enables budgeted
        auto-reset: at most that many envs are re-initialized per step, a
        reset of K envs instead of a dense reset of all of them.  Envs that
        finish beyond the budget freeze (state unchanged, reward 0, done
        False, never truncated) with ``pending_reset`` set until a later
        step's budget reaches them; their episode end was already reported.
        The budget is global: under a mesh the first K needy envs of the
        whole batch are reset, wherever they lie.

        ``mesh``: this rank steps rows ``shard = (start, stop)`` of the
        ``num_envs`` (``local_envs`` of them) on ``mesh.device``; a
        ``device`` that names another raises.
        """
        del jit, donate
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
        self.device = default_device(device, "Env")
        self.game = game
        self.cfg = game.cfg
        self.num_envs = num_envs
        self.shard = None
        if mesh is not None:
            # imported here: the parallel package imports this module
            from .parallel import mesh as mesh_lib

            self.shard = mesh_lib.shard_range(num_envs, mesh)
        self.local_envs = num_envs if mesh is None else self.shard[1] - self.shard[0]
        self.auto_reset = auto_reset
        self.reset_budget = min(reset_budget, num_envs)
        self.final_obs_in_info = final_obs_in_info

    # -- spaces ---------------------------------------------------------

    @property
    def action_space(self) -> Space:
        return Space(shape=self.game.action_shape, dtype=torch.int32,
                     n=self.game.num_actions)

    @property
    def observation_space(self) -> Space:
        dtype = _OBS_DTYPES[self.cfg.obs_type]
        if self.cfg.obs_type == "depth":  # follows EnvConfig.dtype
            dtype = self.game.float_dtype
        return Space(shape=self.cfg.obs_shape, dtype=dtype)

    # -- public ---------------------------------------------------------

    def reset(self, key: torch.Tensor) -> Tuple[EnvState, torch.Tensor]:
        """Reset all envs from one key (split into one key per env; under a
        mesh, this rank's rows of those keys)."""
        keys = rng.split(key.to(self.device), self.num_envs, self.shard)
        state = self.game.reset_batch(keys)
        return state, self.game.observe_batch(state)

    @profiling.span("rcw.env.step")
    def step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        game = self.game
        with profiling.span("rcw.game.step_batch"):
            stepped = game.step_batch(state, action.to(self.device, torch.int32))
        frozen = state.pending_reset if self.reset_budget > 0 else None
        if frozen is not None:
            # envs awaiting a budgeted reset discard their step
            stepped = select(frozen, state, stepped)
            # reward may carry a trailing player axis (MultiPlayerRoom)
            fz = frozen.reshape(frozen.shape + (1,) * (stepped.reward.dim() - 1))
            stepped = stepped.replace(
                reward=torch.where(fz, 0.0, stepped.reward),
                done=stepped.done & ~frozen,
            )
        terminated = stepped.done
        if self.cfg.max_episode_steps > 0:
            truncated = ~terminated & (stepped.t >= self.cfg.max_episode_steps)
            if frozen is not None:
                truncated = truncated & ~frozen
        else:
            truncated = torch.zeros_like(terminated)
        ep_end = terminated | truncated
        profiling.count_device("episodes_ended", ep_end)
        info = {
            "terminal_t": stepped.t,
            "episode_return": stepped.episode_return,
            "terminated": terminated,
            "truncated": truncated,
        }
        if self.auto_reset and self.final_obs_in_info:
            info["final_observation"] = self._observe(stepped)
        if not self.auto_reset:
            nxt = stepped.replace(done=ep_end)
        else:
            with profiling.span("rcw.env.reset"):
                if frozen is not None:
                    nxt = self._budgeted_reset(stepped, frozen | ep_end)
                else:
                    profiling.count("reset_rows", self.local_envs)
                    nxt = select(ep_end, game.reset_batch(stepped.rng_key), stepped)
            # reward/done of the ending transition survive the reset; done
            # marks the episode boundary (terminated or truncated).
            nxt = nxt.replace(reward=stepped.reward, done=ep_end)
        return StepResult(nxt, self._observe(nxt), stepped.reward, ep_end, info)

    def _observe(self, state: EnvState) -> torch.Tensor:
        with profiling.span("rcw.game.observe_batch"):
            return self.game.observe_batch(state)

    def _budgeted_reset(self, stepped: EnvState, needs: torch.Tensor) -> EnvState:
        """Reset the first ``reset_budget`` envs flagged in ``needs`` (in
        index order); the rest keep ``pending_reset`` set.

        An inclusive prefix count over ``needs`` gives each needy env its
        slot.  Slot s resets from the key of the env holding it (the first
        env whose count exceeds s); slots beyond the needy count take env 0's
        key, as in the JAX package, and no env reads them.  Each selected env
        then takes its own slot's fresh row: a gather and a per-env select,
        with no scatter and no host read.

        Under a mesh the needy envs of the lower dp ranks come first: one
        all-reduce of the ranks' needy counts gives the global slots this
        rank's count starts after, and the budget left for its rows.  A
        rank still resets at most ``reset_budget`` rows.
        """
        k = self.reset_budget
        profiling.count("reset_rows", k)
        cnt = torch.cumsum(needs.to(torch.int32), dim=0)
        slot = cnt - 1
        left = k
        if self.mesh is not None:
            counts = torch.zeros(self.mesh.dp, dtype=torch.int64, device=cnt.device)
            counts[self.mesh.dp_index] = cnt[-1]
            self.mesh.all_reduce(counts)
            left = k - counts[:self.mesh.dp_index].sum()
        sel = needs & (slot < left)
        profiling.count_device("budget_resets", sel)
        slots = torch.arange(k, dtype=torch.int32, device=cnt.device)
        idx = torch.searchsorted(cnt, slots, right=True)
        idx = torch.where(idx < needs.shape[0], idx, 0)
        fresh = self.game.reset_batch(stepped.rng_key[idx])
        rows = fresh.index(torch.clamp(slot, 0, k - 1).to(torch.int64))
        return select(sel, rows, stepped).replace(pending_reset=needs & ~sel)

    def sample_action(self, key: torch.Tensor) -> torch.Tensor:
        """Uniform actions for the envs (this rank's rows under a mesh)."""
        shape = (self.num_envs,) + self.game.action_shape
        return rng.randint(key.to(self.device), shape, 0, self.game.num_actions,
                           self.shard)

    def top_view(self, state: EnvState) -> torch.Tensor:
        """Batched uint32 top views (the debug rendering)."""
        return self.game.top_view_batch(state)

    def camera_view(self, state: EnvState) -> torch.Tensor:
        """Batched uint32 camera views whatever the ``obs_type``."""
        return self.game.camera_view_batch(state)
