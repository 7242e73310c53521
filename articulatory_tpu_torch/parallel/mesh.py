"""Process groups and the collectives of data and tensor parallelism (port
of ``articulatory_tpu/parallel/mesh.py``), on ``torch.distributed``.

Where the JAX package lays a device mesh over its processes and lets XLA
insert the gradient all-reduces, the port runs one process a rank and
reduces explicitly:

- ``init_distributed(coordinator_address, num_processes, process_id)``
  joins the process group (``tcp://<address>`` or a ``file://`` path). The
  backend is NCCL when every rank of the host has a card of its own, gloo
  when ranks share a card or run on the CPU; the choice is logged.
- ``make_groups(tensor_parallel)``: the world is dp x tp ranks; tp
  consecutive ranks form a tensor-parallel group, and the ranks with equal
  index in their TP group form a data-parallel group (``Layout``).
- ``replicate(module)`` broadcasts rank 0's parameters and buffers;
  ``all_reduce_grads(params, group)`` averages the gradients over the group
  (one flat buffer a dtype), before the optimizer step, so ``grad_norm``
  clipping sees the global gradient as optax's does under GSPMD;
  ``average`` averages metrics; ``barrier`` waits for every rank;
  ``follow_first`` hands a group's first rank's values to the others
  (the gradients of what a TP group holds replicated).

Every collective here is an ``all_reduce`` or a ``broadcast`` (or a
``barrier``): gloo takes CUDA tensors for those two only (torch 2.11's
build does), and NCCL refuses two ranks on one device, so two ranks
sharing one card run over gloo on the card's tensors. A group of one rank
(or no process group) makes every call a no-op. Each collective is a
``collective`` span (``trace.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Iterable

import torch
import torch.distributed as dist

from articulatory_tpu_torch import trace

SOLO = "solo"  # a group of this rank alone: every collective on it is a no-op
_LAYOUT: "Layout | None" = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def cards(device: torch.device) -> int:
    """Cards in use by the world: a rank each, or on one host
    ``device_count`` shared ones (1 on the CPU)."""
    if device.type != "cuda":
        return 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE") or world_size())
    per_card = -(-local // max(1, torch.cuda.device_count()))
    return max(1, world_size() // per_card)


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when each of the host's ``local_world`` ranks has a card of its
    own, else gloo (ranks sharing a card, or the CPU)."""
    if (device.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= local_world):
        return "nccl"
    return "gloo"


def rank_device(device: str | torch.device | None) -> torch.device:
    """The device of this rank: ``cuda:{LOCAL_RANK % device_count}`` for a
    CUDA request under a launcher, else ``device`` as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for this rank; pass --device "
                "cpu to run the ranks on the CPU")
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                           % torch.cuda.device_count())
    return dev


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: torch.device | None = None) -> str:
    """Join the process group and return its backend. The address is a
    ``host:port`` (``tcp://`` is prefixed) or an ``init_method`` URL such as
    ``file:///path``; the arguments default to ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (or the JAX package's
    ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``)."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("JAX_COORDINATOR_ADDRESS") or (
            f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
            if "MASTER_ADDR" in env else None)
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE")
                            or env.get("JAX_NUM_PROCESSES") or 1)
    if process_id is None:
        process_id = int(env.get("RANK") or env.get("JAX_PROCESS_ID") or 0)
    if coordinator_address is None:
        raise ValueError("no coordinator address: pass one or set "
                         "MASTER_ADDR / MASTER_PORT")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    device = torch.device("cpu") if device is None else device
    local_world = int(env.get("LOCAL_WORLD_SIZE") or num_processes)
    backend = choose_backend(device, local_world)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    logging.warning(
        f"rank {process_id} of {num_processes} on {device}: {backend} "
        + ("(a card a rank)" if backend == "nccl" else
           "(ranks share a card)" if device.type == "cuda" else "(CPU)"))
    return backend


def shutdown() -> None:
    global _LAYOUT
    if is_initialized():
        dist.destroy_process_group()
    _LAYOUT = None


@dataclasses.dataclass
class Layout:
    """The dp x tp ranks: ``tp_group`` holds this rank's tp consecutive
    ranks, ``dp_group`` the ranks with its TP index (``SOLO`` for a group
    of one)."""
    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    dp_group: object | None
    tp_group: object | None


def make_groups(tensor_parallel: int = 1) -> Layout:
    """Split the world into TP and DP groups (every rank makes every group,
    in the same order, as ``new_group`` asks) and keep the layout for
    ``layout()``."""
    global _LAYOUT
    world, me = world_size(), rank()
    tp = int(tensor_parallel)
    if world % tp:
        raise ValueError(f"{world} ranks not divisible by tensor_parallel={tp}")
    dp = world // tp
    tp_group = dp_group = SOLO
    for g in range(dp):
        ranks = list(range(g * tp, (g + 1) * tp))
        group = dist.new_group(ranks) if 1 < tp < world else (
            dist.group.WORLD if tp > 1 else SOLO)
        if me in ranks:
            tp_group = group
    for i in range(tp):
        ranks = list(range(i, world, tp))
        group = dist.new_group(ranks) if 1 < dp < world else (
            dist.group.WORLD if dp > 1 else SOLO)
        if me in ranks:
            dp_group = group
    _LAYOUT = Layout(dp=dp, tp=tp, dp_rank=me // tp, tp_rank=me % tp,
                     dp_group=dp_group, tp_group=tp_group)
    return _LAYOUT


def layout() -> Layout:
    """The layout ``make_groups`` made, else one rank."""
    return _LAYOUT or Layout(1, 1, 0, 0, SOLO, SOLO)


def group_size(group=None) -> int:
    """Ranks in ``group`` (the world for None; 1 without a process
    group)."""
    if group is SOLO or not is_initialized():
        return 1
    return dist.get_world_size(group)


def _collective(fn, tensor: torch.Tensor, *args, **kwargs) -> None:
    with trace.span("collective"):
        fn(tensor, *args, **kwargs)


def all_reduce(tensor: torch.Tensor, group=None, op=None) -> torch.Tensor:
    """In-place sum (or ``op``) over ``group`` (the world with None while a
    process group exists); a no-op for one rank."""
    if group_size(group) == 1:
        return tensor
    _collective(dist.all_reduce, tensor, op=op or dist.ReduceOp.SUM,
                group=group)
    return tensor


def broadcast(tensor: torch.Tensor, src: int = 0, group=None
              ) -> torch.Tensor:
    """In place from global rank ``src``; a no-op for one rank."""
    if group_size(group) == 1:
        return tensor
    _collective(dist.broadcast, tensor, src=src, group=group)
    return tensor


def barrier() -> None:
    if is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _flat_reduce(tensors: list[torch.Tensor], group, scale: float) -> None:
    """All-reduce ``tensors`` in place through one flat buffer a dtype."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        all_reduce(flat, group)
        if scale != 1.0:
            flat.mul_(scale)
        offset = 0
        for t in same:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def all_reduce_grads(params: Iterable[torch.Tensor], group=None) -> None:
    """Average the parameters' gradients over ``group`` (a missing gradient
    counts as zero and is made so)."""
    n = group_size(group)
    if n == 1:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _flat_reduce([p.grad for p in params], group, 1.0 / n)


def follow_first(tensors: Iterable[torch.Tensor], group) -> None:
    """Every rank of ``group`` takes the group's first rank's values of
    ``tensors`` (one broadcast a dtype): what the ranks compute alike from
    the same inputs can still differ in its last bits where a cuDNN
    reduction is not deterministic, and replicas must stay bit-equal."""
    if group_size(group) == 1:
        return
    src = dist.get_global_rank(group, 0) if group is not None else 0
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        broadcast(flat, src, group)
        offset = 0
        for t in same:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def replicate(module: torch.nn.Module, group=None, src: int = 0) -> None:
    """Broadcast ``module``'s parameters and buffers from rank ``src``."""
    if group_size(group) == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            broadcast(t.data, src, group)


def average(values: dict, group=None) -> dict:
    """``{key: float}`` averaged over ``group`` (one all-reduce); the keys
    must be the same on every rank."""
    n = group_size(group)
    if n == 1 or not values:
        return dict(values)
    keys = sorted(values)
    flat = torch.tensor([float(values[k]) for k in keys],
                        dtype=torch.float64, device=_comm_device())
    all_reduce(flat, group)
    return {k: float(v) / n for k, v in zip(keys, flat.tolist())}


def broadcast_float(value: float, src: int = 0) -> float:
    """``value`` from rank ``src`` on every rank."""
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=_comm_device())
    return float(broadcast(t, src)[0])


def _comm_device() -> torch.device:
    """Where host scalars travel: the card under NCCL, else the CPU."""
    if is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# Differentiable all-reduces (Megatron's f and g). Under tensor parallelism
# a region of rank-local work starts from a replicated activation and ends
# in partial sums: ``copy_to`` marks the entry (identity forward, the
# gradients' sum backward, since each rank's gradient is a partial one),
# ``reduce_from`` the exit (the sum forward, identity backward, since the
# sum is replicated and so is its gradient). ``reduce_both`` sums both ways:
# a sum that every rank then uses in rank-local work (a weight norm over
# split input channels, BatchNorm's statistics over a split batch).

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def reduce_both(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceBoth.apply(x, group)
