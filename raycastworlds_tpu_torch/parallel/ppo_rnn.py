"""Recurrent PPO (GRU actor-critic) for partially observable worlds.

The port of ``raycastworlds_tpu.parallel.ppo_rnn``: the trainer carries a
GRU hidden state through the rollout, zeroed after a done so that each
episode starts from h = 0, and replays the recurrence during the update.
Minibatches are drawn over the env axis only (time order must be kept to
replay the GRU); each one replays its sequences from the stored
rollout-start hidden state under the current params, then takes the
clipped-PPO step.  Hidden states pass between train steps detached.

Single-agent.  ``mesh=`` (the env's) is data-parallel only, as in JAX:
each rank holds its rows of the env state and of the hidden carry, draws
its rows of every action, permutes its own envs with one replicated
permutation (``permutation(kp, B/dp)``, the dp-local shuffle) and
normalizes advantages over the global minibatch; gradients and metrics are
all-reduced over dp.  The params and Adam state are replicated on every
rank, mp ranks included.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from .. import rng
from ..env import Env
from ..state import EnvState
from .mesh import Mesh
from .ppo import (
    Dense,
    ImageTrunk,
    Optimizer,
    Params,
    PPOConfig,
    adam_init,
    compute_gae,
    dp_mean,
    feature_shape,
    init_params,
    log_prob_of,
    mean_metrics,
    policy_loss_terms,
    preprocess_obs,
    shard_train_state,
    success_metrics,
    train_loop,
    trainer_mesh,
)


class GRUCell(nn.Module):
    """flax ``nn.GRUCell(features, dtype=dtype)``: input Dense layers ``ir``,
    ``iz``, ``in`` with a bias, recurrent ``hr``, ``hz`` without one and
    ``hn`` with one (orthogonal kernels).  Unlike ``torch.nn.GRUCell`` there
    is no bias on the recurrent r and z gates.

        r = sigmoid(ir(x) + hr(h));  z = sigmoid(iz(x) + hz(h))
        n = tanh(in(x) + r * hn(h));  h' = (1 - z) * n + z * h
    """

    def __init__(self, fan_in: int, features: int, dtype):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, Dense(fan_in, features, dtype))
        for name in ("hr", "hz", "hn"):
            self.add_module(name, Dense(features, features, dtype, bias=name == "hn",
                                        init="orthogonal"))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        m = self._modules
        r = torch.sigmoid(m["ir"](x) + m["hr"](h))
        z = torch.sigmoid(m["iz"](x) + m["hz"](h))
        n = torch.tanh(m["in"](x) + r * m["hn"](h))
        return (1.0 - z) * n + z * h


class RecurrentActorCritic(nn.Module):
    """Conv/patch/MLP feature trunk -> ``embed`` Dense -> GRU cell -> policy
    and value heads: the JAX package's ``RecurrentActorCritic``.  The carry
    stays float32 across steps; compute runs in ``dtype``.  Built on the
    ``meta`` device, like ``ActorCritic``."""

    def __init__(self, shape, num_actions: int = 4, hidden: int = 256,
                 dtype=torch.float32, trunk: str = "conv"):
        super().__init__()
        self.dtype = dtype
        self.features = ImageTrunk(shape, dtype, trunk)
        self.embed = Dense(self.features.out_features, hidden, dtype)
        self.gru = GRUCell(hidden, hidden, dtype)
        self.policy = Dense(hidden, num_actions, dtype)
        self.value = Dense(hidden, 1, dtype)

    def forward(self, x: torch.Tensor, h: torch.Tensor):
        e = F.relu(self.embed(self.features(x)))
        new_h = self.gru(h.to(self.dtype), e)
        logits, value = self.policy(new_h), self.value(new_h)
        return (logits.to(torch.float32), value.to(torch.float32)[..., 0],
                new_h.to(torch.float32))


class RnnTrainState(NamedTuple):
    params: Params
    opt_state: Dict[str, Any]
    env_state: EnvState
    hidden: torch.Tensor    # f32[B, hidden], carried across train steps
    key: torch.Tensor
    update_count: int


class RecurrentPPOTrainer:
    """Owns the GRU network and builds the train step; runs on
    ``env.device`` (over the ranks of the env's ``mesh``, dp only)."""

    def __init__(self, env: Env, ppo_cfg: PPOConfig = PPOConfig(), hidden: int = 256,
                 dtype=torch.float32, trunk: str = "conv", mesh: Optional[Mesh] = None):
        if env.game.action_shape != ():
            raise ValueError(
                "RecurrentPPOTrainer is single-agent; fold the player axis "
                "with the feedforward PPOTrainer for MultiPlayerRoom"
            )
        self.mesh = trainer_mesh(env, mesh)
        # Env(mesh=...) has already refused a num_envs that dp does not divide
        if env.local_envs % ppo_cfg.num_minibatches:
            raise ValueError(
                "per-shard env count (num_envs / dp) must divide by "
                "num_minibatches"
            )
        self.env = env
        self.cfg = ppo_cfg
        self.hidden = hidden
        self.net = RecurrentActorCritic(feature_shape(env), env.game.num_actions,
                                        hidden, dtype, trunk)

    def init(self, key: torch.Tensor) -> RnnTrainState:
        dev = self.env.device
        k_env, k_net, k_run = rng.split(key.to(dev), 3).unbind(0)
        env_state, _ = self.env.reset(k_env)
        params = init_params(self.net, k_net, dev)
        h0 = torch.zeros((self.env.local_envs, self.hidden), device=dev)
        return RnnTrainState(params, adam_init(params), env_state, h0, k_run, 0)

    def shard(self, ts: RnnTrainState) -> RnnTrainState:
        """This rank's piece of a global train state (``shard_train_state``)."""
        return shard_train_state(ts, self.mesh)

    def _rollout_phase(self, ts: RnnTrainState, k_roll: torch.Tensor):
        """Rollout with the hidden carry, one key per step split from
        ``k_roll``, then the bootstrap value and GAE.  Returns (env_state,
        last hidden, data [T, B, ...], aux metrics)."""
        env, cfg, net, mesh = self.env, self.cfg, self.net, self.mesh
        state, obs, h = ts.env_state, env.game.observe_batch(ts.env_state), ts.hidden
        recs = []
        for k in rng.split(k_roll, cfg.rollout_steps).unbind(0):
            logits, value, h2 = functional_call(
                net, ts.params, (preprocess_obs(env.cfg, obs), h))
            action = rng.categorical(k, logits, env.shard)
            res = env.step(state, action)
            # episode boundary: the next step starts a fresh episode, h = 0
            h = torch.where(res.done[:, None], 0.0, h2)
            recs.append((obs, action, log_prob_of(F.log_softmax(logits, dim=-1), action),
                         value, res.reward, res.done))
            state, obs = res.state, res.obs
        obs_t, act_t, lp_t, val_t, rew_t, done_t = (torch.stack(x) for x in zip(*recs))
        _, last_value, _ = functional_call(
            net, ts.params, (preprocess_obs(env.cfg, obs), h))
        adv, target = compute_gae(rew_t, val_t, done_t, last_value, cfg.gamma,
                                  cfg.gae_lambda)
        data = {"obs": obs_t, "action": act_t, "log_prob": lp_t, "advantage": adv,
                "target": target, "done": done_t}
        aux = {"reward_per_step": dp_mean(rew_t.mean(), mesh),
               **success_metrics(rew_t, done_t, mesh)}
        return state, h, data, aux

    def _replay_loss(self, params: Params, batch):
        """Replay the GRU over the [T, mb] sequences under ``params`` from
        ``batch["h0"]``, then the clipped-PPO loss."""
        h, logits, values = batch["h0"], [], []
        for o, d in zip(batch["obs"], batch["done"]):
            lg, v, h2 = functional_call(
                self.net, params, (preprocess_obs(self.env.cfg, o), h))
            h = torch.where(d[:, None], 0.0, h2)
            logits.append(lg)
            values.append(v)
        return policy_loss_terms(self.cfg, torch.stack(logits), torch.stack(values), batch,
                                 self.mesh)

    def _update_phase(self, params, opt_state, k_perm, hidden, data):
        """Epochs x env-axis minibatches; each epoch permutes the envs once
        (``permutation`` over B, or over this rank's B/dp under a mesh).
        Returns (params, opt_state, metrics)."""
        cfg = self.cfg
        bl = self.env.local_envs
        mbl = bl // cfg.num_minibatches
        opt = Optimizer(params, opt_state, cfg, self.mesh)
        metrics, key = [], k_perm
        for _ in range(cfg.num_epochs):
            key, kp = rng.split(key).unbind(0)
            perm = rng.permutation(kp, bl)
            for i in range(cfg.num_minibatches):
                envs = perm[i * mbl:(i + 1) * mbl]
                batch = {k: v[:, envs] for k, v in data.items()}
                batch["h0"] = hidden[envs]
                loss, m = self._replay_loss(opt.params, batch)
                opt.step(loss)
                metrics.append(m)
        return (*opt.state(), mean_metrics(metrics, self.mesh))

    def train_step(self, ts: RnnTrainState):
        key, k_roll, k_perm = rng.split(ts.key, 3).unbind(0)
        with torch.no_grad():
            env_state, h_last, data, aux = self._rollout_phase(ts, k_roll)
        params, opt_state, metrics = self._update_phase(
            ts.params, ts.opt_state, k_perm, ts.hidden, data)
        metrics.update(aux)
        return RnnTrainState(params, opt_state, env_state, h_last, key,
                             ts.update_count + 1), metrics

    def train(self, key: torch.Tensor, num_updates: int, log_every: int = 10):
        return train_loop(self, key, num_updates, log_every)
