"""Tensor parallelism of the HiFi-GAN generator (port of
``articulatory_tpu/parallel/tp.py``).

The JAX package shards conv kernels on their output channels and lets
GSPMD insert the collectives; any such sharding is exact there, so the
layout is a choice. The port splits the generator over a TP group of
``size`` ranks with Megatron's pair of collectives (``parallel/mesh.py``:
``copy_to`` at a region's entry, ``reduce_from`` at its exit), so that each
rank holds about 1/size of its convolution weights and needs only
``all_reduce``:

- the input conv, each upsampler and the output conv are split by input
  channels (contiguous ranges, ``channel_ranges``); each rank convolves its
  channels, the partial outputs are all-reduced in float32 (float64 kept)
  and the bias is added once. An upsampler's weight norm is per input
  channel, so it stays local; a Conv1d's spans its input channels, so the
  squared norms of the ranges are all-reduced (``reduce_both``);
- each MRF gives whole residual blocks to ranks, balanced by taps
  (``block_owners``: tp 2 over kernels (3, 7, 11) is {3, 7} | {11}); each
  rank sums its blocks, the sums are all-reduced in float32 and divided by
  the number of blocks. Every pair stays a whole ``resblock_pair`` call;
- the conditioning (AR encoder, speaker and phoneme embeddings, the
  phoneme head) is replicated.

The discriminator stays replicated across a TP group, as in JAX; the TP
group shares its batch and its draws, the data-parallel group averages the
gradients, and the gradients of whatever a TP group holds replicated (the
discriminator, the generator's conditioning, biases and weight-norm
gains) are TP rank 0's on every rank (``sync_replicated_grads``,
``mesh.follow_first``): cuDNN's reductions are not all deterministic, and
the replicas must not drift apart. ``shard_generator_`` splits a full generator in place (the
sharded modules keep the full model's parameter names, the blocks of other
ranks become ``nn.Identity``); ``utils/weights.py``'s ``split_tp_state_dict`` /
``gather_tp_state_dicts``
move full state dicts to ranks' and back, ``full_state`` gathers the live
shards (weights and optimizer state) over the group for a checkpoint, which
is always written full, and ``load_optimizer_state`` hands a rank its part
of a full optimizer state.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from articulatory_tpu_torch.ops import conv as conv_ops
from articulatory_tpu_torch.parallel import mesh
from articulatory_tpu_torch.utils.weights import (
    block_owners,
    channel_ranges,
    tp_key_spec,
    tp_part,
)

@dataclasses.dataclass
class Plan:
    """A sharded generator's place in its TP group."""
    group: object
    rank: int
    size: int
    owners: list[int]
    specs: dict  # full state-dict key -> key_spec
    full_shapes: dict  # full state-dict key -> shape
    full_names: list[str]  # the full generator's parameter names, in order

    def mine(self, block: int) -> bool:
        return self.owners[block] == self.rank


def shard_generator_(generator: nn.Module, group, rank: int, size: int
                     ) -> Plan:
    """Split ``generator`` (a full ``HiFiGANGenerator``) in place for rank
    ``rank`` of the TP group ``group`` and return its ``Plan`` (also set as
    ``generator.tp``); its forward then runs the rank's part."""
    nb = generator.num_blocks
    owners = block_owners(list(generator.resblock_kernel_sizes), size)
    full = generator.state_dict()
    specs = {k: tp_key_spec(k, t.shape, size, nb, owners)
             for k, t in full.items()}
    plan = Plan(group=group, rank=rank, size=size, owners=owners,
                specs=specs, full_shapes={k: tuple(t.shape)
                                          for k, t in full.items()},
                full_names=[n for n, _ in generator.named_parameters()])
    with torch.no_grad():
        for key, spec in specs.items():
            if spec[0] != "split":
                continue
            prefix, name = key.rsplit(".", 1)
            module = generator.get_submodule(prefix)
            part = tp_part(full[key], spec, rank, size).clone()
            setattr(module, name, nn.Parameter(part))
            if name != "weight_g":  # the input channels this rank takes
                module.tp_range = channel_ranges(
                    full[key].shape[spec[1]], size)[rank]
    for n in range(len(generator.blocks)):
        if not plan.mine(n % nb):
            generator.blocks[n] = nn.Identity()
    generator.tp = plan
    return plan


def sharded_params(generator: nn.Module) -> list[torch.Tensor]:
    """The parameters whose gradients differ between the TP ranks (split
    and owned ones); the rest are replicated and their gradients equal."""
    plan = generator.tp
    return [p for n, p in generator.named_parameters()
            if plan.specs[n][0] != "replicated"]


def sync_replicated_grads(generator: nn.Module) -> None:
    """The replicated parameters' gradients of TP rank 0 on every rank of
    the group, so the replicas stay bit-equal."""
    plan = generator.tp
    mesh.follow_first([p.grad for n, p in generator.named_parameters()
                       if plan.specs[n][0] == "replicated"
                       and p.grad is not None], plan.group)


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def conv1d_split(conv, x: torch.Tensor, dtype: torch.dtype | None,
                 plan: Plan) -> torch.Tensor:
    """A ``layers/conv.py::Conv1d`` split by input channels: this rank's
    channels (``conv.tp_range``) of the replicated ``x``, the partial
    outputs summed over the group, the bias added once."""
    if getattr(conv, "tp_range", None) is None:  # too narrow to split
        return conv(x, dtype)
    dtype = dtype or x.dtype
    lo, hi = conv.tp_range
    x = mesh.copy_to(x, plan.group)[..., lo:hi]
    if conv.use_weight_norm:
        v = conv.weight_v
        g = mesh.copy_to(conv.weight_g, plan.group)
        norm2 = mesh.reduce_both(v.square().sum(dim=(1, 2), keepdim=True),
                                 plan.group)
        w = g * v / norm2.sqrt()
    else:
        w = conv.weight
    part = conv_ops.conv1d(x.to(dtype), w.permute(2, 1, 0).to(dtype)
                           .contiguous(), None, stride=conv.stride,
                           padding=conv.padding, dilation=conv.dilation)
    return _reduced(part, conv.bias, dtype, plan)


def conv_transpose1d_split(conv, x: torch.Tensor,
                           dtype: torch.dtype | None, plan: Plan
                           ) -> torch.Tensor:
    """A ``ConvTranspose1d`` split by input channels (its weight norm is
    per input channel, so local), the partial outputs summed, the bias
    added once."""
    if getattr(conv, "tp_range", None) is None:  # too narrow to split
        return conv(x, dtype)
    dtype = dtype or x.dtype
    lo, hi = conv.tp_range
    x = mesh.copy_to(x, plan.group)[..., lo:hi]
    w = conv._ops_kernel(conv.torch_weight()).to(dtype).contiguous()
    part = conv_ops.conv_transpose1d(
        x.to(dtype), w, None, stride=conv.stride, padding=conv.padding,
        output_padding=conv.output_padding, dilation=conv.dilation)
    return _reduced(part, conv.bias, dtype, plan)


def _reduced(part: torch.Tensor, bias: torch.Tensor | None,
             dtype: torch.dtype, plan: Plan) -> torch.Tensor:
    out = mesh.reduce_from(_at_least_f32(part), plan.group)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.to(dtype)


def mrf_split(blocks, x: torch.Tensor, first: int, num_blocks: int,
              dtype: torch.dtype | None, plan: Plan) -> torch.Tensor:
    """The MRF of a stage: this rank's blocks summed, the sums all-reduced
    (at least float32), divided by the number of blocks."""
    x = mesh.copy_to(x, plan.group)
    part = None
    for j in range(num_blocks):
        if plan.mine(j):
            y = blocks[first + j](x, dtype)
            part = y if part is None else part + y
    out = mesh.reduce_from(_at_least_f32(part), plan.group) / num_blocks
    return out.to(part.dtype)


def clip_norm_fn(generator: nn.Module):
    """The global gradient norm of a sharded generator's parameters for
    ``Optimizer``'s clipping: the squared norms of the sharded gradients
    summed over the TP group, the replicated ones counted once."""
    plan = generator.tp
    sharded = {id(p) for p in sharded_params(generator)}

    def norm(params) -> torch.Tensor:
        grads = [(p.grad, id(p) in sharded) for p in params
                 if p.grad is not None]
        sq_sharded = sum((g.square().sum() for g, s in grads if s),
                         torch.zeros((), device=grads[0][0].device,
                                     dtype=grads[0][0].dtype))
        sq_repl = sum((g.square().sum() for g, s in grads if not s),
                      torch.zeros_like(sq_sharded))
        total = mesh.all_reduce(sq_sharded.clone(), plan.group) + sq_repl
        return total.sqrt()

    return norm


def _gathered(local: torch.Tensor | None, key: str, plan: Plan,
              like: torch.Tensor) -> torch.Tensor:
    """Entry ``key`` at its full shape on every rank, from the ranks'
    parts (an all-reduce of zero-padded parts)."""
    spec = plan.specs[key]
    if spec[0] == "replicated":
        return local
    full = torch.zeros(plan.full_shapes[key], dtype=like.dtype,
                       device=like.device)
    if spec[0] == "split":
        lo, hi = channel_ranges(full.shape[spec[1]], plan.size)[plan.rank]
        full.narrow(spec[1], lo, hi - lo).copy_(local)
    elif local is not None:
        full.copy_(local)
    return mesh.all_reduce(full, plan.group)


def full_state(generator: nn.Module, optimizer=None) -> tuple[dict, dict | None]:
    """The full generator state dict and, with ``optimizer`` (over the
    sharded generator's parameters, in their order), its full optimizer
    state dict, indexed as one built over the full generator; every rank
    of the group gets them (every rank must call)."""
    plan = generator.tp
    local = generator.state_dict()
    probe = next(iter(local.values()))
    sd = {}
    for key in plan.full_shapes:
        sd[key] = _gathered(local.get(key), key, plan, local.get(key, probe))
    if optimizer is None:
        return sd, None
    opt = optimizer.state_dict()
    names = [n for n, _ in generator.named_parameters()]
    local_state = {names[i]: s for i, s in opt["state"].items()}
    template = next(iter(local_state.values()), None)
    has_state = mesh.all_reduce(torch.tensor(
        [0.0 if template is None else 1.0], device=_comm(probe)),
        plan.group)
    state = {}
    if float(has_state[0]) > 0:
        if template is None:
            raise RuntimeError("optimizer state on some TP ranks only")
        for j, name in enumerate(plan.full_names):
            entry = local_state.get(name)
            state[j] = {}
            for k, v in template.items():
                mine = None if entry is None else entry[k]
                if torch.is_tensor(v) and v.dim() > 0:
                    state[j][k] = _gathered(mine, name, plan, v)
                elif plan.specs[name][0] == "owned":
                    t = (mine if mine is not None else torch.zeros_like(v))
                    state[j][k] = mesh.all_reduce(
                        t.clone().to(_comm(probe)), plan.group).to(v.device)
                else:
                    state[j][k] = mine
    groups = [dict(g, params=list(range(len(plan.full_names))))
              for g in opt["param_groups"]]
    return sd, {"state": state, "param_groups": groups}


def _comm(like: torch.Tensor) -> torch.device:
    return mesh._comm_device() if like.device.type == "cpu" else like.device


def load_optimizer_state(optimizer, full_state_dict: dict,
                         generator: nn.Module) -> None:
    """Load rank's part of a full optimizer state (indexed over the full
    generator's parameters) into ``optimizer`` over the sharded
    generator's parameters."""
    plan = generator.tp
    names = [n for n, _ in generator.named_parameters()]
    index = {n: j for j, n in enumerate(plan.full_names)}
    state = {}
    for i, name in enumerate(names):
        entry = full_state_dict["state"].get(index[name])
        if entry is None:
            continue
        state[i] = {k: (tp_part(v, plan.specs[name], plan.rank, plan.size)
                        .clone() if torch.is_tensor(v) and v.dim() > 0
                        else v) for k, v in entry.items()}
    groups = [dict(g, params=list(range(len(names))))
              for g in full_state_dict["param_groups"]]
    optimizer.load_state_dict({"state": state, "param_groups": groups})
