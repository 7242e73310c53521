"""BatchNorm with the JAX package's (flax's) semantics and torch's keys.

Over the last axis of ``(..., C)`` input. In training it normalises with
the batch's mean and biased variance and moves the running statistics by
``momentum`` (flax's convention: ``running = momentum * running + (1 -
momentum) * batch``, the *biased* variance, where torch's ``BatchNorm1d``
takes the unbiased one); in evaluation it uses the running statistics. The
keys are torch's (``weight``, ``bias``, ``running_mean``, ``running_var``,
``num_batches_tracked``), so reference pickles load straight in.

``frozen_stats(module)`` keeps every BatchNorm's statistics in place for
the forwards inside it (the training step's regeneration pass, and a
generator step its schedule turns off, as JAX's masked update does).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:  # one fused kernel over (N, C)
            # flax's dtypes (bfloat16 storage): computed in the statistics'
            # dtype or wider, returned in that of x, scale and bias
            dtype = torch.promote_types(x.dtype, self.running_mean.dtype)
            out = torch.promote_types(torch.promote_types(
                x.dtype, self.weight.dtype), self.bias.dtype)
            return F.batch_norm(x.reshape(-1, x.shape[-1]).to(dtype),
                                self.running_mean, self.running_var,
                                self.weight.to(dtype), self.bias.to(dtype),
                                False, 0.0, self.eps
                                ).reshape(x.shape).to(out)
        dims = tuple(range(x.dim() - 1))
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
                self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * scale + self.bias


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Run the forwards inside without moving any BatchNorm's statistics."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True
