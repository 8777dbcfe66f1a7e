"""PPO learner on the device that steps the envs (BASELINE config 5).

The port of ``raycastworlds_tpu.parallel.ppo``: an actor-critic whose train
step is a rollout through ``Env.step`` (every observation cast and rendered
on the device, through the crossing cast kernel under ``auto`` on the
card), GAE, and epochs x minibatches of clipped-PPO updates.  PyTorch runs
it eagerly: the rollout and the GAE are Python loops, as the JAX package's
``lax.scan``s are loops over the same steps.

The train step is a function of its ``TrainState``, as in JAX: params and
optimizer state are plain dictionaries of tensors (the module is built on
the ``meta`` device and called with ``torch.func.functional_call``), so a
state can be stepped twice, compared, checkpointed or carried over from
the JAX package (``parallel/params.py``).  The networks' convolutions and
products are plain PyTorch, as the JAX package leaves them to XLA.

``mesh=`` (``parallel/mesh.py``, the env's mesh) trains over ranks as the
JAX trainer trains over a mesh of the same shape:

* dp: each rank rolls out its rows of the env batch and shuffles its own
  ``[T, B/dp]`` samples with one replicated permutation (JAX's dp-local
  shuffle), so the global minibatch is the ranks' minibatches side by
  side.  Advantages are normalized by the global minibatch's mean and
  population std, gradients and metrics are all-reduced and averaged over
  dp, and the replicated params and Adam moments stay bit-identical on
  every rank.
* mp: the ``trunk`` Dense is column-parallel (its weight rows and bias
  split, ``param_shard_dim``) and the ``policy`` and ``value`` heads are
  row-parallel (their partial products summed over mp, the bias added
  once), as JAX's ``param_shardings`` places them; ``trunk2`` (the mlp
  trunk's) is replicated and takes the gathered hidden units.  Adam's
  moments stay sharded with their params.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from .. import rng
from ..config import EnvConfig
from ..env import Env
from ..state import EnvState
from . import mesh as mesh_lib
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh
from .rollout import Trajectory, rollout_policy

Params = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# Observation preprocessing
# ---------------------------------------------------------------------------


def _div255(x: torch.Tensor) -> torch.Tensor:
    # by a tensor on x's device: CUDA divides by a CPU scalar through its
    # reciprocal, which is not the float32 division JAX does
    return x / torch.tensor(255.0, device=x.device)


def preprocess_obs(cfg: EnvConfig, obs: torch.Tensor) -> torch.Tensor:
    """Map any obs_type to float32 features with a trailing channel axis
    (images) or a flat vector (depth / tile_grid), the JAX package's floats
    exactly.

    camera_pal8 decodes by a gather from the palette's float32 RGB table
    (``cfg.palette_rgb_f32``, each byte / 255 in float32): the same floats
    as the JAX package's packed-byte select (palettes up to 64 entries) and
    its one-hot product (the extended textured palettes).
    """
    t = cfg.obs_type
    if t == "camera_u32":
        x = obs.view(torch.int32)  # colours < 2**24: the shifts need no mask
        chans = [((x >> s) & 0xFF).to(torch.float32) for s in (16, 8, 0)]
        return _div255(torch.stack(chans, dim=-1))
    if t == "camera_rgb":
        return _div255(obs.to(torch.float32))
    if t == "camera_gray":
        return obs[..., None].to(torch.float32)
    if t == "camera_pal8":
        table = torch.from_numpy(cfg.palette_rgb_f32).to(obs.device)
        return table[obs.to(torch.int64)]
    if t == "camera_gray_u8":
        return _div255(obs[..., None].to(torch.float32))
    if t == "depth":
        return obs.to(torch.float32)
    if t == "tile_grid":
        return obs.reshape(obs.shape[:-2] + (-1,)).to(torch.float32)
    if t in ("top_u32", "top_rgb"):
        raise ValueError(
            "top views are debug renders; train on a camera_* / depth / "
            "tile_grid observation instead"
        )
    raise ValueError(t)


def feature_shape(env: Env) -> Tuple[int, ...]:
    """Per-sample shape of ``preprocess_obs``'s features for ``env``, the
    player axis of MultiPlayerRoom folded away."""
    shape = env.observation_space.shape
    if env.game.action_shape:
        shape = shape[1:]
    zeros = torch.zeros((1,) + tuple(shape), dtype=env.observation_space.dtype)
    return tuple(preprocess_obs(env.cfg, zeros).shape[1:])


# ---------------------------------------------------------------------------
# Layers written as flax's
# ---------------------------------------------------------------------------

# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so that its variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Module):
    """flax ``nn.Dense(features, dtype=dtype)``: the input, weight and bias
    cast to the compute ``dtype``, the product, then the bias added.  The
    weight is held as torch's ``[out, in]`` (flax's kernel transposed); the
    params stay float32.  ``init`` is "lecun" (flax's default) or
    "orthogonal" (the GRU's recurrent kernels).  ``row_parallel`` (a mesh):
    the input and the weight's columns are this rank's block of an mp
    split, and the partial products are summed over mp before the bias is
    added."""

    def __init__(self, fan_in: int, features: int, dtype, bias: bool = True,
                 init: str = "lecun", row_parallel: Optional[Mesh] = None):
        super().__init__()
        self.dtype = dtype
        self.init = init
        self.row_parallel = row_parallel
        self.weight = nn.Parameter(torch.empty(features, fan_in, device="meta"))
        self.bias = (nn.Parameter(torch.empty(features, device="meta"))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        if self.row_parallel is not None:
            y = mesh_lib.reduce_mp(y, self.row_parallel)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides=(s, s), padding=...)`` on an
    NCHW input: ``"SAME"`` pads as XLA does (total ``max((out-1)*s + k - n,
    0)``, the odd pixel after), ``"VALID"`` not at all.  Weight OIHW (flax's
    HWIO kernel permuted)."""

    def __init__(self, in_ch: int, features: int, k: int, stride: int,
                 padding: str, dtype):
        super().__init__()
        self.dtype = dtype
        self.init = "lecun"
        self.k, self.stride, self.padding = k, stride, padding
        self.weight = nn.Parameter(torch.empty(features, in_ch, k, k, device="meta"))
        self.bias = nn.Parameter(torch.empty(features, device="meta"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.padding == "SAME":
            pads = []
            for n in (x.shape[3], x.shape[2]):  # F.pad wants the last axis first
                total = max((-(-n // self.stride) - 1) * self.stride + self.k - n, 0)
                pads += [total // 2, total - total // 2]
            x = F.pad(x, pads)
        y = F.conv2d(x, self.weight.to(self.dtype), stride=self.stride)
        return y + self.bias.to(self.dtype)[:, None, None]


class ImageTrunk(nn.Module):
    """The feature extractor shared by both actor-critics: on images
    ``[B, H, W, C]`` the two 4x4/stride-2 convolutions (``"conv"``), the 8x8
    patch embedding (``"patch"``) or nothing (``"mlp"``), then the flatten;
    vectors pass through.  The flatten is NHWC, as flax's: the conv output
    is permuted back to channels-last before it, so the trunk Dense's
    weight is flax's kernel transposed, unpermuted.  ``out_features`` is
    the flattened width."""

    def __init__(self, shape: Tuple[int, ...], dtype, trunk: str):
        super().__init__()
        self.dtype, self.trunk = dtype, trunk
        self.image = len(shape) >= 3
        if not self.image:
            self.out_features = int(np.prod(shape))
            return
        h, w, c = shape
        if trunk == "patch":
            self.patch = Conv(c, 64, 8, 8, "VALID", dtype)
            self.out_features = (h // 8) * (w // 8) * 64
        elif trunk == "mlp":
            self.out_features = h * w * c
        else:
            self.conv0 = Conv(c, 16, 4, 2, "SAME", dtype)
            self.conv1 = Conv(16, 32, 4, 2, "SAME", dtype)
            for _ in range(2):
                h, w = -(-h // 2), -(-w // 2)
            self.out_features = h * w * 32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if not self.image:
            return x
        if self.trunk != "mlp":
            x = x.permute(0, 3, 1, 2)
            if self.trunk == "patch":
                x = F.relu(self.patch(x))
            else:
                x = F.relu(self.conv1(F.relu(self.conv0(x))))
            x = x.permute(0, 2, 3, 1)
        return x.reshape(x.shape[0], -1)


def init_params(net: nn.Module, key: torch.Tensor, device) -> Params:
    """Fresh params of ``net`` drawn as flax draws them, from a CPU
    ``torch.Generator`` seeded with ``key``'s two words: kernels lecun
    normal (truncated normal, variance 1 / fan_in), the GRU's recurrent
    kernels orthogonal, biases zero.  Not JAX's stream: the same
    distributions, and the same params for the same key on every device."""
    k0, k1 = (int(v) for v in key.tolist())
    gen = torch.Generator().manual_seed((k0 << 32) | k1)
    out = {}
    for prefix, mod in net.named_modules():
        if not isinstance(mod, (Dense, Conv)):
            continue
        w = torch.empty(mod.weight.shape)
        if mod.init == "orthogonal":
            nn.init.orthogonal_(w, generator=gen)
        else:
            std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
        out[prefix + ".weight"] = w.to(device)
        if mod.bias is not None:
            out[prefix + ".bias"] = torch.zeros(mod.bias.shape, device=device)
    return out


# ---------------------------------------------------------------------------
# Actor-critic network
# ---------------------------------------------------------------------------


class ActorCritic(nn.Module):
    """Conv / patch / MLP trunk with policy and value heads: the JAX
    package's ``ActorCritic`` (see its docstring for the trunks).

    ``shape`` is the per-sample feature shape (``feature_shape``).  Compute
    runs in ``dtype`` (float32 or bfloat16: every layer casts its input,
    weight and bias, as flax's ``dtype=`` does; no autocast); params stay
    float32 and logits and value come back float32.  The module is built on
    the ``meta`` device: call it with params through ``functional_call``.

    Under a ``mesh`` with ``mp > 1`` the forward is tensor-parallel and
    takes this rank's mp shards of the params (``shard_params``); the
    module's own (meta) params keep the full shapes that ``init_params``
    draws.
    """

    def __init__(self, shape: Tuple[int, ...], num_actions: int = 4,
                 hidden: int = 256, dtype=torch.float32, trunk: str = "conv",
                 mesh: Optional[Mesh] = None):
        super().__init__()
        self.tp = mesh if mesh is not None and mesh.mp > 1 else None
        if self.tp is not None and hidden % self.tp.mp:
            raise ValueError(f"hidden={hidden} not divisible by mp={self.tp.mp}")
        self.features = ImageTrunk(shape, dtype, trunk)
        self.trunk = Dense(self.features.out_features, hidden, dtype)
        # the mlp trunk's second hidden layer (see the JAX docstring)
        self.trunk2 = Dense(hidden, hidden, dtype) if trunk == "mlp" else None
        self.policy = Dense(hidden, num_actions, dtype, row_parallel=self.tp)
        self.value = Dense(hidden, 1, dtype, row_parallel=self.tp)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        tp = self.tp
        x = self.features(x)
        if tp is not None:
            x = mesh_lib.enter_mp(x, tp)
        x = F.relu(self.trunk(x))  # under mp: this rank's hidden units
        if self.trunk2 is not None:
            if tp is not None:
                x = mesh_lib.gather_mp(x, tp)
            x = F.relu(self.trunk2(x))
            if tp is not None:  # the heads' rows: this rank's hidden units
                w = x.shape[-1] // tp.mp
                x = mesh_lib.enter_mp(x, tp)[..., tp.mp_index * w:(tp.mp_index + 1) * w]
        logits, value = self.policy(x), self.value(x)
        return logits.to(torch.float32), value.to(torch.float32)[..., 0]


def param_shard_dim(name: str) -> Optional[int]:
    """The axis of an ``ActorCritic`` param that is split over mp, as the
    JAX package's ``param_shardings``: 0 for the ``trunk`` weight's rows
    and its bias (flax's kernel columns), 1 for the ``policy`` and
    ``value`` weights' columns (flax's kernel rows); None (replicated) for
    the rest, ``trunk2`` included."""
    layer, leaf = name.rsplit(".", 1)
    if layer == "trunk":
        return 0
    if layer in ("policy", "value") and leaf == "weight":
        return 1
    return None


def shard_params(params: Params, mesh: Mesh) -> Params:
    """This rank's mp shards of full ``ActorCritic`` params (or of Adam
    moments laid out as the params), copied to its device."""
    out = {}
    for k, v in params.items():
        dim = param_shard_dim(k)
        if dim is not None and mesh.mp > 1:
            n = v.shape[dim] // mesh.mp
            v = v.narrow(dim, mesh.mp_index * n, n)
        out[k] = v.to(mesh.device, copy=True)
    return out


def gather_params(params: Params, mesh: Mesh) -> Params:
    """The full params from every mp rank's shards (a collective)."""
    if mesh.mp == 1:
        return dict(params)
    return {k: v if param_shard_dim(k) is None
            else mesh.gather(v.contiguous(), MODEL_AXIS, dim=param_shard_dim(k))
            for k, v in params.items()}


def shard_train_state(ts, mesh: Mesh):
    """This rank's piece of a global (one-process) ``TrainState`` or
    ``RnnTrainState``: its env rows (and hidden carry), its mp shards of
    the feedforward params and Adam moments (the GRU's stay whole), the
    key and counts as they are; the JAX trainers' ``shard``."""
    recurrent = "hidden" in ts._fields

    def params(p):
        if recurrent:
            return {k: v.to(mesh.device, copy=True) for k, v in p.items()}
        return shard_params(p, mesh)

    out = ts._replace(
        params=params(ts.params),
        opt_state=dict(ts.opt_state, mu=params(ts.opt_state["mu"]),
                       nu=params(ts.opt_state["nu"])),
        env_state=mesh_lib.shard_env_state(ts.env_state, mesh),
        key=ts.key.to(mesh.device, copy=True))
    return out._replace(hidden=mesh_lib.shard_rows(ts.hidden, mesh)) if recurrent else out


def gather_train_state(ts, mesh: Mesh):
    """The global train state from every rank's piece (a collective; every
    rank gets it), for checkpoints and tests."""
    recurrent = "hidden" in ts._fields

    def params(p):
        return dict(p) if recurrent else gather_params(p, mesh)

    out = ts._replace(
        params=params(ts.params),
        opt_state=dict(ts.opt_state, mu=params(ts.opt_state["mu"]),
                       nu=params(ts.opt_state["nu"])),
        env_state=mesh_lib.gather_env_state(ts.env_state, mesh))
    return out._replace(hidden=mesh.gather(ts.hidden)) if recurrent else out


# ---------------------------------------------------------------------------
# PPO machinery
# ---------------------------------------------------------------------------


class PPOConfig(NamedTuple):
    rollout_steps: int = 64
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    num_epochs: int = 2
    num_minibatches: int = 4


class TrainState(NamedTuple):
    params: Params
    opt_state: Dict[str, Any]  # {"count": int, "mu": Params, "nu": Params}
    env_state: EnvState
    key: torch.Tensor
    update_count: int


def compute_gae(
    reward: torch.Tensor,      # [T, B]
    value: torch.Tensor,       # [T, B]
    done: torch.Tensor,        # [T, B]
    last_value: torch.Tensor,  # [B]
    gamma: float,
    lam: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over a time-major rollout, a reverse
    loop in the JAX scan's order of operations.  ``done`` marks the
    transition as terminal (value bootstrap masked) -- at a time-limit
    truncation too, as in the JAX package."""
    gae = torch.zeros_like(last_value)
    next_value = last_value
    adv = [None] * reward.shape[0]
    for t in range(reward.shape[0] - 1, -1, -1):
        nonterm = 1.0 - done[t].to(torch.float32)
        delta = reward[t] + gamma * next_value * nonterm - value[t]
        gae = delta + gamma * lam * nonterm * gae
        adv[t] = gae
        next_value = value[t]
    adv = torch.stack(adv)
    return adv, adv + value


def log_prob_of(log_probs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """``log_probs[..., action]``: the taken action's log-probability."""
    return torch.take_along_dim(log_probs, action.to(torch.int64)[..., None], dim=-1)[..., 0]


def make_policy_fn(net: ActorCritic, cfg: EnvConfig, params: Params, num_players=0,
                   shard=None):
    """Policy closure for rollouts.  ``num_players > 0`` (MultiPlayerRoom)
    runs one parameter-shared network over the folded [B*P] batch and
    returns per-player actions int32[B, P].  ``shard``: the env rows of the
    global batch that ``obs`` holds (``Env.shard``); the actions are drawn
    as those rows of the global draw."""

    def policy(obs, key):
        x = preprocess_obs(cfg, obs)
        if num_players:
            b = x.shape[0]
            x = x.reshape((b * num_players,) + x.shape[2:])
        logits, value = functional_call(net, params, (x,))
        if num_players:
            logits = logits.reshape(b, num_players, -1)
            value = value.reshape(b, num_players)
        action = rng.categorical(key, logits, shard)
        return action, log_prob_of(F.log_softmax(logits, dim=-1), action), value

    return policy


def normalize_advantage(adv: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``(adv - mean) / (std + 1e-8)`` with the population std, as
    ``jnp.std``.  Under a mesh of dp > 1 the mean and std are the global
    minibatch's (every dp rank's ``adv`` together): two all-reduces, of the
    sum and of the squared deviations."""
    if mesh is None or mesh.dp == 1:
        return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    n = adv.numel() * mesh.dp
    mean = mesh.all_reduce(adv.sum(), DATA_AXIS) / n
    var = mesh.all_reduce(((adv - mean) ** 2).sum(), DATA_AXIS) / n
    return (adv - mean) / (torch.sqrt(var) + 1e-8)


def policy_loss_terms(cfg: PPOConfig, logits, value, batch,
                      mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, dict]:
    """The clipped-PPO loss of ``logits``/``value`` against ``batch``
    (action, log_prob, advantage, target), the advantage normalized over the
    batch with the population std, as ``jnp.std``.  Under a mesh the batch
    is this rank's part of the global minibatch: the advantage is
    normalized over all of it, and the loss is this rank's mean, whose mean
    over dp is the global loss."""
    log_probs = F.log_softmax(logits, dim=-1)
    lp = log_prob_of(log_probs, batch["action"])
    ratio = torch.exp(lp - batch["log_prob"])
    adv = normalize_advantage(batch["advantage"], mesh)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    policy_loss = -torch.mean(torch.minimum(unclipped, clipped))
    value_loss = 0.5 * torch.mean((value - batch["target"]) ** 2)
    entropy = -torch.mean(torch.sum(torch.exp(log_probs) * log_probs, dim=-1))
    loss = policy_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
    return loss, {
        "loss": loss,
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy": entropy,
    }


def ppo_loss(net: ActorCritic, env_cfg: EnvConfig, cfg: PPOConfig, params: Params,
             batch: Dict[str, torch.Tensor], mesh: Optional[Mesh] = None):
    x = preprocess_obs(env_cfg, batch["obs"])
    logits, value = functional_call(net, params, (x,))
    return policy_loss_terms(cfg, logits, value, batch, mesh)


# ---------------------------------------------------------------------------
# Optimizer: optax.chain(clip_by_global_norm(max_norm), adam(lr))
# ---------------------------------------------------------------------------


def adam_init(params: Params) -> Dict[str, Any]:
    """optax.adam's initial state: count 0, zero moments."""
    return {
        "count": 0,
        "mu": {k: torch.zeros_like(v) for k, v in params.items()},
        "nu": {k: torch.zeros_like(v) for k, v in params.items()},
    }


def clip_by_global_norm(grads, max_norm: float, mesh: Optional[Mesh] = None,
                        sharded=()):
    """optax's rule: ``g * max_norm / norm`` (as ``g / norm * max_norm``)
    where the global norm reaches ``max_norm``, ``g`` below it.  Unlike
    ``torch.nn.utils.clip_grad_norm_``, no epsilon is added to the norm;
    the choice stays on the device.  ``sharded``: the positions of the
    grads that are mp shards, whose squares are summed over mp (each
    replicated one counts once)."""
    if not sharded:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    else:
        sq = [torch.sum(g * g) for g in grads]
        part = mesh.all_reduce(sum(sq[i] for i in sharded), MODEL_AXIS)
        norm = torch.sqrt(part + sum(x for i, x in enumerate(sq) if i not in sharded))
    return [torch.where(norm < max_norm, g, g / norm * max_norm) for g in grads]


class Optimizer:
    """One update phase's optimizer: ``torch.optim.Adam(lr, eps=1e-8)``
    after optax's global-norm clip, over fresh leaf copies of ``params``
    with the moments and count of ``opt_state`` (neither argument is
    changed).  ``state()`` returns the updated (params, opt_state).

    Under a ``mesh`` the gradients are summed over dp in one all-reduce of
    a flat buffer and divided by dp before the clip; ``sharded`` names the
    params that are mp shards (for the global norm)."""

    def __init__(self, params: Params, opt_state: Dict[str, Any], cfg: PPOConfig,
                 mesh: Optional[Mesh] = None, sharded=()):
        self.mesh = mesh
        self.sharded = {i for i, k in enumerate(params) if k in sharded}
        self.max_norm = cfg.max_grad_norm
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.adam = torch.optim.Adam(self.params.values(), lr=cfg.lr, eps=1e-8)
        for k, p in self.params.items():
            self.adam.state[p] = {
                "step": torch.tensor(float(opt_state["count"])),
                "exp_avg": opt_state["mu"][k].clone(),
                "exp_avg_sq": opt_state["nu"][k].clone(),
            }

    def step(self, loss: torch.Tensor) -> None:
        """One update on the gradients of ``loss``."""
        self.apply(torch.autograd.grad(loss, list(self.params.values())))

    def apply(self, grads) -> None:
        """One update on ``grads`` (in the order of the params; this rank's
        under a mesh)."""
        if self.mesh is not None:
            flat = self.mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), DATA_AXIS)
            if self.mesh.dp > 1:
                flat = flat / self.mesh.dp
            grads = [x.view_as(g) for x, g in zip(flat.split([g.numel() for g in grads]), grads)]
        clipped = clip_by_global_norm(grads, self.max_norm, self.mesh, self.sharded)
        for p, g in zip(self.params.values(), clipped):
            p.grad = g
        self.adam.step()

    def state(self) -> Tuple[Params, Dict[str, Any]]:
        st = [self.adam.state[p] for p in self.params.values()]
        return {k: p.detach() for k, p in self.params.items()}, {
            "count": int(st[0]["step"]),
            "mu": {k: s["exp_avg"] for k, s in zip(self.params, st)},
            "nu": {k: s["exp_avg_sq"] for k, s in zip(self.params, st)},
        }


def dp_mean(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` averaged over the dp ranks (``x`` itself without a mesh)."""
    return x if mesh is None else mesh.mean(x)


def mean_metrics(metrics: list, mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """Each metric's mean over the minibatches of every epoch (and over the
    dp ranks, in one all-reduce, under a mesh)."""
    means = torch.stack([torch.stack([m[k].detach() for m in metrics]).mean()
                         for k in metrics[0]])
    return dict(zip(metrics[0], dp_mean(means, mesh).unbind(0)))


def success_metrics(reward: torch.Tensor, done: torch.Tensor,
                    mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """Episodes finished and the goal-reach rate among them (truncations
    score 0), from the rollout's episode-level rewards and dones; under a
    mesh both counts are summed over dp first."""
    n_ep = done.to(torch.int32).sum()
    n_succ = (done & (reward > 0)).to(torch.int32).sum()
    if mesh is not None:
        n_ep, n_succ = mesh.sum(torch.stack([n_ep, n_succ])).unbind(0)
    rate = torch.where(n_ep > 0, n_succ / torch.clamp(n_ep, min=1), 0.0)
    return {"episodes_finished": n_ep, "success_rate": rate}


def train_loop(trainer, key: torch.Tensor, num_updates: int, log_every: int):
    """``trainer.init(key)``, then ``num_updates`` train steps; every
    ``log_every`` updates and at the last, the metrics as floats with
    ``update`` and ``elapsed_s`` (wall clock since the start)."""
    ts = trainer.init(key)
    history = []
    t0 = time.perf_counter()
    for u in range(num_updates):
        ts, metrics = trainer.train_step(ts)
        if (u + 1) % log_every == 0 or u == num_updates - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["update"] = u + 1
            m["elapsed_s"] = round(time.perf_counter() - t0, 2)
            history.append(m)
    return ts, history


def trainer_mesh(env: Env, mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The trainers' mesh: the env's, which ``mesh`` may name again."""
    if mesh is not None and mesh is not env.mesh:
        raise ValueError("the trainer's mesh must be its env's: Env(..., mesh=mesh)")
    return env.mesh


class PPOTrainer:
    """Owns the network and builds the train step; runs on ``env.device``.

    MultiPlayerRoom trains one parameter-shared policy by folding the player
    axis into the batch (obs [B, P, ...] -> [B*P, ...]; the episode-level
    done broadcast to every player for GAE).  ``mesh`` (the env's, see the
    module docstring) trains over the mesh's ranks.
    """

    def __init__(self, env: Env, ppo_cfg: PPOConfig = PPOConfig(), hidden: int = 256,
                 dtype=torch.float32, trunk: str = "conv", mesh: Optional[Mesh] = None):
        self.env = env
        self.cfg = ppo_cfg
        self.mesh = trainer_mesh(env, mesh)
        ashape = env.game.action_shape
        self.num_players = ashape[0] if ashape else 0
        self.net = ActorCritic(feature_shape(env), env.game.num_actions, hidden, dtype, trunk,
                               self.mesh)
        self.sharded = () if self.net.tp is None else tuple(
            k for k, _ in self.net.named_parameters() if param_shard_dim(k) is not None)

    def init(self, key: torch.Tensor) -> TrainState:
        """Env reset and fresh params; under a mesh every rank draws the
        full params and keeps its mp shards."""
        k_env, k_net, k_run = rng.split(key.to(self.env.device), 3).unbind(0)
        env_state, _ = self.env.reset(k_env)
        params = init_params(self.net, k_net, self.env.device)
        if self.net.tp is not None:
            params = shard_params(params, self.mesh)
        return TrainState(params, adam_init(params), env_state, k_run, 0)

    def shard(self, ts: TrainState) -> TrainState:
        """This rank's piece of a global train state (``shard_train_state``)."""
        return shard_train_state(ts, self.mesh)

    def _rollout_phase(self, ts: TrainState, k_roll: torch.Tensor):
        """Rollout + last-value bootstrap + GAE.  Returns (env_state, traj
        [player axis folded], adv, target, aux metrics)."""
        env, cfg, net, mesh = self.env, self.cfg, self.net, self.mesh
        policy = make_policy_fn(net, env.cfg, ts.params, self.num_players, env.shard)
        env_state, traj = rollout_policy(env, policy, ts.env_state, k_roll,
                                         cfg.rollout_steps)
        p = self.num_players
        # counted before the fold, so that each episode counts once
        aux = success_metrics(traj.reward.sum(-1) if p else traj.reward, traj.done, mesh)
        if p:
            for k in range(p):
                aux[f"reward_p{k}"] = dp_mean(traj.reward[:, :, k].mean(), mesh)
            def fold(x):
                return x.reshape(x.shape[:1] + (-1,) + x.shape[3:])

            done = traj.done[:, :, None].expand(traj.done.shape + (p,))
            traj = Trajectory(fold(traj.obs), fold(traj.action), fold(traj.reward),
                              fold(done), fold(traj.log_prob), fold(traj.value))
        last_x = preprocess_obs(env.cfg, env.game.observe_batch(env_state))
        if p:
            last_x = last_x.reshape((-1,) + last_x.shape[2:])
        _, last_value = functional_call(net, ts.params, (last_x,))
        adv, target = compute_gae(traj.reward, traj.value, traj.done, last_value,
                                  cfg.gamma, cfg.gae_lambda)
        aux["reward_per_step"] = dp_mean(traj.reward.mean(), mesh)
        return env_state, traj, adv, target, aux

    def _update_phase(self, params, opt_state, k_perm, traj, adv, target):
        """Epochs x minibatches of clipped-PPO updates over one rollout,
        each epoch's minibatches cut from one ``permutation`` of the T*B
        time-major samples (under a mesh: of this rank's T*B/dp, the JAX
        trainer's dp-local shuffle).  Returns (params, opt_state, metrics)."""
        cfg = self.cfg
        t_len, b = traj.action.shape
        n = t_len * b
        flat = {
            "obs": traj.obs.reshape((n,) + traj.obs.shape[2:]),
            "action": traj.action.reshape(n),
            "log_prob": traj.log_prob.reshape(n),
            "advantage": adv.reshape(n),
            "target": target.reshape(n),
        }
        mb = n // cfg.num_minibatches
        opt = Optimizer(params, opt_state, cfg, self.mesh, self.sharded)
        metrics, key = [], k_perm
        for _ in range(cfg.num_epochs):
            key, kp = rng.split(key).unbind(0)
            perm = rng.permutation(kp, n)
            for i in range(cfg.num_minibatches):
                idx = perm[i * mb:(i + 1) * mb]
                batch = {k: v[idx] for k, v in flat.items()}
                loss, m = ppo_loss(self.net, self.env.cfg, cfg, opt.params, batch, self.mesh)
                opt.step(loss)
                metrics.append(m)
        return (*opt.state(), mean_metrics(metrics, self.mesh))

    def train_step(self, ts: TrainState):
        key, k_roll, k_perm = rng.split(ts.key, 3).unbind(0)
        with torch.no_grad():
            env_state, traj, adv, target, aux = self._rollout_phase(ts, k_roll)
        params, opt_state, metrics = self._update_phase(
            ts.params, ts.opt_state, k_perm, traj, adv, target)
        metrics.update(aux)
        return TrainState(params, opt_state, env_state, key, ts.update_count + 1), metrics

    def train(self, key: torch.Tensor, num_updates: int, log_every: int = 10):
        return train_loop(self, key, num_updates, log_every)
