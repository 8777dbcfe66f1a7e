"""The (dp, mp) mesh over ``torch.distributed`` ranks, and sharding helpers.

The port of ``raycastworlds_tpu.parallel.mesh``.  In JAX one program spans
every device of a named mesh and XLA inserts the collectives from sharding
annotations.  Here every device is driven by a rank of its own (a process),
and the port writes its few collectives out:

* ``dp`` (data parallel): the env batch is split into ``dp`` contiguous
  slices of rows; a rank steps only its own slice, and the trainers
  all-reduce their gradients, advantage statistics and metrics over ``dp``.
* ``mp`` (tensor parallel): the feedforward trainer's trunk Dense is split
  by columns and its heads by rows over ``mp`` (``parallel/ppo.py``); the
  ranks of one ``mp`` group hold the same env rows.

Ranks are numbered row-major over ``(dp, mp)``, as the JAX mesh reshapes its
device list: ``rank = dp_index * mp + mp_index``.  Every collective is an
``all_reduce`` (an all-gather is the all-reduce of a zero-padded buffer), so
the same code runs under NCCL with one rank per card and under gloo where
several ranks share one card (NCCL refuses two ranks on one GPU); gloo
reduces a CUDA tensor through a host copy made on the caller's stream.  Both transports give every rank the same reduced
bytes (each element is reduced once, then copied to every rank), which
keeps the replicated params bit-identical across ranks.

JAX's ``replicated`` sharding has no counterpart: a value that JAX
replicates (params, optimizer state, keys) is simply held whole by every
rank.  Start ranks with ``torchrun`` (``initialize_distributed`` reads its
environment) or with :func:`launch`.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..state import EnvState
from ..utils import profiling

DATA_AXIS = "dp"
MODEL_AXIS = "mp"

# all-gathers sum signed-integer views of the rows: exact for every value,
# -0.0 and NaN payloads included
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64, torch.bool: torch.uint8,
         torch.uint32: torch.int32}


def initialize_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> None:
    """Join the process group (nothing for one process, or where the group
    exists).  Arguments left None come from torchrun's environment
    (``WORLD_SIZE``, ``RANK``, ``init_method="env://"``); ``backend`` None
    is NCCL where CUDA is available, else gloo."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 or dist.is_initialized():
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on the (dp, mp) mesh: the axis sizes, its indices,
    its device and the groups of the ranks it reduces with (the ``dp``
    group: the ranks of its ``mp_index``; the ``mp`` group: the ranks of
    its ``dp_index``).  A group is None in a process without a process
    group, where every collective is the identity."""

    dp: int
    mp: int
    dp_index: int
    mp_index: int
    device: torch.device
    dp_group: Any = None
    mp_group: Any = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.mp}

    @property
    def rank(self) -> int:
        return self.dp_index * self.mp + self.mp_index

    def _axis(self, axis: str):
        if axis == DATA_AXIS:
            return self.dp_group, self.dp, self.dp_index
        if axis == MODEL_AXIS:
            return self.mp_group, self.mp, self.mp_index
        raise ValueError(f"unknown mesh axis {axis!r}")

    def all_reduce(self, t: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
        """Sum ``t`` in place over ``axis``'s group; returns ``t``.  Each
        all-reduce runs in the ``rcw.mesh.all_reduce`` span (under NCCL the
        enqueue, under gloo the whole transfer) and counts
        ``mesh_collectives``."""
        group = self._axis(axis)[0]
        if group is None:
            return t
        with profiling.span("rcw.mesh.all_reduce"):
            if t.is_cuda and dist.get_backend(group) == "gloo":
                # staged on the caller's stream: the copy out waits for the
                # kernels that wrote ``t`` and every later kernel reads the
                # sum, with no side stream of gloo's between them
                host = t.cpu()
                dist.all_reduce(host, group=group)
                t.copy_(host)
            else:
                dist.all_reduce(t, group=group)
        profiling.count("mesh_collectives")
        return t

    def sum(self, t: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
        """The sum of ``t`` over ``axis`` (a new tensor)."""
        return self.all_reduce(t.clone(), axis)

    def mean(self, t: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
        """The mean of ``t`` over ``axis`` (a new tensor)."""
        n = self._axis(axis)[1]
        s = self.sum(t, axis)
        return s if n == 1 else s / n

    def gather(self, t: torch.Tensor, axis: str = DATA_AXIS, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` of ``axis``, concatenated along ``dim`` in
        index order: the all-reduce of a buffer that is zero but for this
        rank's slot, summed in integer bits, so it is exact."""
        group, n, index = self._axis(axis)
        if group is None:
            if n != 1:
                raise RuntimeError(f"mesh axis {axis} has {n} ranks but no process group")
            return t
        bits = _BITS.get(t.dtype, t.dtype)
        buf = torch.zeros((n,) + tuple(t.shape), dtype=bits, device=t.device)
        buf[index] = t.view(bits)
        self.all_reduce(buf, axis)
        return torch.cat(buf.view(t.dtype).unbind(0), dim=dim)

    def barrier(self) -> None:
        """Wait for every rank (an all-reduce over the whole world)."""
        if dist.is_initialized():
            dist.all_reduce(torch.zeros(1, device=self.device))


def make_mesh(
    dp: Optional[int] = None,
    mp: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """This rank's mesh of shape (dp, mp) over every rank of the process
    group (one rank where there is none).  ``dp=None`` uses all the ranks
    that ``mp`` leaves.  ``devices`` is the device of each rank, in rank
    order (several ranks may name one card); by default rank r of a host
    takes ``cuda:LOCAL_RANK``, one rank per visible card, and more ranks
    than cards raise instead of piling onto one card unasked.  Every rank
    must call this, in the same order as its other group creations."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dp is None:
        if world % mp:
            raise ValueError(f"{world} ranks not divisible by mp={mp}")
        dp = world // mp
    if dp * mp != world:
        raise ValueError(f"dp*mp={dp * mp} != #ranks={world}")
    if devices is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(
                f"{local_world} ranks on this host and {cards} CUDA devices: pass "
                "devices= to place ranks on a shared card or on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    else:
        devices = list(devices)
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = Mesh(dp, mp, rank // mp, rank % mp, device)
    if dist.is_initialized():
        # every rank creates every group, in the same order
        for j in range(mp):
            g = dist.new_group([i * mp + j for i in range(dp)])
            if j == mesh.mp_index:
                mesh.dp_group = g
        for i in range(dp):
            g = dist.new_group([i * mp + j for j in range(mp)])
            if i == mesh.dp_index:
                mesh.mp_group = g
    return mesh


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    if global_batch % mesh.dp:
        raise ValueError(f"batch {global_batch} not divisible by dp={mesh.dp}")
    return global_batch // mesh.dp


def shard_range(num_envs: int, mesh: Mesh) -> Tuple[int, int]:
    """The rows ``[start, stop)`` of a ``num_envs`` batch that this rank
    holds: its dp slice."""
    n = local_batch_size(num_envs, mesh)
    return mesh.dp_index * n, (mesh.dp_index + 1) * n


def shard_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a global ``[B, ...]`` tensor, copied to its
    device."""
    start, stop = shard_range(t.shape[0], mesh)
    return t[start:stop].to(mesh.device, copy=True)


def shard_env_state(state: EnvState, mesh: Mesh) -> EnvState:
    """This rank's rows of a global batched state, on its device."""
    return state.replace(**{k: shard_rows(v, mesh) for k, v in state.leaves().items()})


def gather_env_state(state: EnvState, mesh: Mesh) -> EnvState:
    """The global state from every rank's rows (a collective: every rank
    calls it and every rank gets the whole state), for checkpoints and
    tests."""
    return state.replace(**{k: mesh.gather(v) for k, v in state.leaves().items()})


# ---------------------------------------------------------------------------
# The tensor-parallel boundary (autograd through the mp collectives)
# ---------------------------------------------------------------------------


class _EnterMp(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.sum(g, MODEL_AXIS), None


class _ReduceMp(torch.autograd.Function):
    """Sum of the ranks' partial results forward; identity backward (every
    rank computes the same loss from the sum)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.sum(x, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherMp(torch.autograd.Function):
    """The ranks' column blocks concatenated on the last axis forward; the
    backward keeps this rank's block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return mesh.gather(x.contiguous(), MODEL_AXIS, dim=-1)

    @staticmethod
    def backward(ctx, g):
        i, w = ctx.mesh.mp_index, ctx.width
        return g[..., i * w:(i + 1) * w], None


def enter_mp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated activation entering an mp-parallel region."""
    return _EnterMp.apply(x, mesh)


def reduce_mp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of a row-parallel product's partial results over mp."""
    return _ReduceMp.apply(x, mesh)


def gather_mp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A column-parallel activation made whole: ``[..., w]`` -> ``[..., mp * w]``."""
    return _GatherMp.apply(x, mesh)


# ---------------------------------------------------------------------------
# Starting ranks
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, world_size, backend, store, threads, args, results) -> None:
    if threads:
        torch.set_num_threads(threads)
    try:
        initialize_distributed(backend, f"file://{store}", world_size, rank)
        results.put((rank, True, fn(*args)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(
    fn: Callable,
    world_size: int,
    backend: str = "gloo",
    args: tuple = (),
    store: Optional[str] = None,
    threads: Optional[int] = None,
    timeout: float = 1800.0,
) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` ranks, each a process started by
    ``torch.multiprocessing`` ("spawn") and joined to a process group of
    ``backend`` over a ``file://`` store (``store``: a path that does not
    exist yet; a fresh temporary one by default).  ``fn`` must be
    importable by the children (a module-level function) and builds its
    own mesh (:func:`make_mesh`, with ``devices`` where ranks share a card
    or run on the CPU).  ``threads`` sets each rank's torch threads.
    Returns each rank's return value, in rank order; a rank that raises,
    dies or outlasts ``timeout`` seconds stops every rank and raises here."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    if store is None:
        store = os.path.join(tempfile.mkdtemp(prefix="rcw_store_"), "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, backend, store, threads, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    error = None
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size and error is None:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    error = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                elif time.monotonic() > deadline:
                    error = f"ranks still running after {timeout} s"
                continue
            if ok:
                out[rank] = value
            else:
                error = f"rank {rank} raised:\n{value}"
    finally:
        for p in procs:
            if error is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if error is not None:
        raise RuntimeError(error)
    return [out[r] for r in range(world_size)]
