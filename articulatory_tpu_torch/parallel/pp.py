"""Pipeline parallelism: stage-split generator serving (port of
``articulatory_tpu/parallel/pp.py``).

The HiFi-GAN generator is a chain of stages (``HiFiGANGenerator.
run_stages``: the conditioning and input conv, one upsample + MRF group
each, the output conv). ``PipelinedGenerator`` places contiguous stage
groups on devices and streams microbatches through them. Each group runs
on a CUDA stream of its own: stage group k of microbatch j waits on an
event that group k - 1 recorded after microbatch j, so group k of
microbatch j overlaps group k + 1 of microbatch j - 1 (GPipe's inference
schedule; JAX gets the same overlap from per-device async dispatch). On one
card every group sits on that card, each on its own stream. On the CPU the
groups run in order.

A group whose device is the model's runs the model's own modules; a group
on another device holds a copy of its stages' modules only
(``stage_param_subset`` names their parameters). Chaining the stages is the
forward bit for bit, and a microbatch split is exact (the generator couples
no batch rows). The handoff is the raw activation between stages.
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch
from torch import nn


def even_boundaries(num_stages: int, num_groups: int) -> list[int]:
    """Split ``range(num_stages)`` into ``num_groups`` contiguous chunks:
    ``num_groups + 1`` boundaries (first 0, last num_stages), chunks
    differing by at most one stage."""
    if not 1 <= num_groups <= num_stages:
        raise ValueError(f"need 1 <= num_groups <= {num_stages}, got "
                         f"{num_groups}")
    base, extra = divmod(num_stages, num_groups)
    bounds = [0]
    for g in range(num_groups):
        bounds.append(bounds[-1] + base + (1 if g < extra else 0))
    return bounds


def stage_modules(model: nn.Module, start: int, stop: int) -> list[str]:
    """The names of the submodules that stages ``[start, stop)`` of a
    ``HiFiGANGenerator`` run."""
    n_up = len(model.upsamples)
    names = []
    if start == 0:
        names += [n for n in ("ar_model", "spk_emb_mat", "spk_fc",
                              "ph_emb_mat") if hasattr(model, n)]
        names.append("input_conv")
    for i in range(n_up):
        if start <= i + 1 < stop:
            names.append(f"upsamples.{i}")
            names += [f"blocks.{i * model.num_blocks + j}"
                      for j in range(model.num_blocks)]
    if stop == n_up + 2:
        names.append("output_conv")
        if hasattr(model, "ph_fc"):
            names.append("ph_fc")
    return names


def stage_param_subset(model: nn.Module, start: int, stop: int
                       ) -> dict[str, torch.Tensor]:
    """The state-dict entries that stages ``[start, stop)`` use."""
    prefixes = tuple(n + "." for n in stage_modules(model, start, stop))
    return {k: v for k, v in model.state_dict().items()
            if k.startswith(prefixes)}


def _stage_copy(model: nn.Module, start: int, stop: int,
                device: torch.device) -> nn.Module:
    """A copy of ``model`` on ``device`` holding the stages' modules only
    (the others replaced by ``nn.Identity``)."""
    keep = set(stage_modules(model, start, stop))
    shell = copy.copy(model)
    shell._modules = dict(model._modules)
    for name in ("ar_model", "spk_emb_mat", "spk_fc", "ph_emb_mat",
                 "input_conv", "output_conv", "ph_fc"):
        if name in shell._modules and name not in keep:
            shell._modules[name] = nn.Identity()
    for name in ("upsamples", "blocks"):
        shell._modules[name] = nn.ModuleList([
            m if f"{name}.{i}" in keep else nn.Identity()
            for i, m in enumerate(model._modules[name])])
    return copy.deepcopy(shell).to(device)


class PipelinedGenerator:
    """Stage-split generator over ``devices``; call it like the model.

    ``model``: a ``HiFiGANGenerator`` (any module with ``run_stages`` and
    ``num_pipeline_stages``); ``devices``: one a stage group (length K <=
    num_pipeline_stages, repeats allowed); ``boundaries``: K + 1 stage
    indices, first 0, last num_pipeline_stages (default an even split);
    ``num_microbatches``: the batch is split into this many per call (it
    must divide the batch size)."""

    def __init__(self, model: nn.Module, devices: Sequence,
                 boundaries: Sequence[int] | None = None,
                 num_microbatches: int = 2):
        n_stages = model.num_pipeline_stages
        k = len(devices)
        if boundaries is None:
            boundaries = even_boundaries(n_stages, k)
        boundaries = list(boundaries)
        if (len(boundaries) != k + 1 or boundaries[0] != 0
                or boundaries[-1] != n_stages
                or any(a >= b for a, b in zip(boundaries, boundaries[1:]))):
            raise ValueError(
                f"boundaries must be {k + 1} strictly increasing ints from 0 "
                f"to {n_stages}, got {boundaries}")
        if num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1")
        if getattr(model, "ph_pool", None) is not None:
            raise ValueError("pipeline serving is inference-only; the ph "
                             "auxiliary head (use_ph_loss) is a training "
                             "feature — disable it for serving")
        self.model = model
        self.devices = [torch.device(d) for d in devices]
        self.boundaries = boundaries
        self.num_microbatches = num_microbatches
        home = next(model.parameters()).device
        self.groups = []
        for dev, start, stop in zip(self.devices, boundaries, boundaries[1:]):
            module = (model if dev == home
                      else _stage_copy(model, start, stop, dev))
            stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                      else None)
            self.groups.append((module, start, stop, dev, stream))

    @torch.inference_mode()
    def __call__(self, c: torch.Tensor, ar: torch.Tensor | None = None,
                 spk_id: torch.Tensor | None = None,
                 ph: torch.Tensor | None = None) -> torch.Tensor:
        # the model's positional order (the port's forward: c, ar, spk_id,
        # ph), so code written against the model runs unchanged
        b, m = c.shape[0], self.num_microbatches
        if b % m != 0:
            raise ValueError(f"batch {b} not divisible by num_microbatches "
                             f"{m}")

        def split(x):
            return None if x is None else torch.chunk(x, m, dim=0)

        cs, ars, spks, phs = split(c), split(ar), split(spk_id), split(ph)
        caller = (torch.cuda.current_stream(c.device) if c.is_cuda
                  else None)
        outs = []
        for j in range(m):
            x = cs[j]
            ready = caller.record_event() if caller is not None else None
            for i, (module, start, stop, dev, stream) in enumerate(
                    self.groups):
                kwargs = {}
                if i == 0:
                    kwargs = {k: None if v is None else v[j]
                              for k, v in (("ar", ars), ("spk_id", spks),
                                           ("ph", phs))}
                x, ready = self._run(module, start, stop, dev, stream, x,
                                     ready, kwargs)
            outs.append((x, ready))
        results = []
        for x, ready in outs:
            if ready is not None and caller is not None:
                caller.wait_event(ready)
                x.record_stream(caller)
            results.append(x.to(c.device))
        return torch.cat(results, dim=0)

    @staticmethod
    def _run(module, start, stop, dev, stream, x, ready, kwargs):
        """One stage group on one microbatch, on its stream after the
        event ``ready``; returns the output and the event marking it
        done."""
        if stream is None:
            kwargs = {k: None if v is None else v.to(dev)
                      for k, v in kwargs.items()}
            return module.run_stages(x.to(dev), start, stop, **kwargs), None
        if ready is not None:
            stream.wait_event(ready)
        with torch.cuda.stream(stream):
            for v in [x, *kwargs.values()]:
                if v is not None and v.is_cuda:
                    v.record_stream(stream)
            kwargs = {k: None if v is None else v.to(dev)
                      for k, v in kwargs.items()}
            y = module.run_stages(x.to(dev), start, stop, **kwargs)
        return y, stream.record_event()
