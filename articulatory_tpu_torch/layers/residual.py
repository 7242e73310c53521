"""``HiFiGANResidualBlock`` (port of ``articulatory_tpu/layers/residual.py``).

Per dilation, ``x = x + conv2(act(conv1(act(x))))``. With
``use_additional_convs`` each dilation is exactly one fused residual pair,
``ops/resblock_pair.resblock_pair`` (the CUDA kernel on a card, its plain
version on the CPU). Without it a branch is ``x + conv1(act(x))``, one conv
through ``ops/conv.py``. Submodules follow the reference's keys:
``convs1.{d}.1`` and ``convs2.{d}.1`` (index 0 is the activation).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from articulatory_tpu_torch.layers.conv import Conv1d
from articulatory_tpu_torch.ops.resblock_pair import resblock_pair


class HiFiGANResidualBlock(nn.Module):
    def __init__(self, kernel_size: int = 3, channels: int = 512,
                 dilations: Sequence[int] = (1, 3, 5), bias: bool = True,
                 use_additional_convs: bool = True,
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: dict | None = None,
                 use_weight_norm: bool = True,
                 kernel_init: str = "torch_default", time_pack: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        del time_pack  # a TPU layout transform; the math is the plain conv
        if kernel_size % 2 != 1:
            raise ValueError("Kernel size must be odd number.")
        if nonlinear_activation != "LeakyReLU":
            raise NotImplementedError(
                "the port's residual block runs LeakyReLU only (the fused "
                f"pair's activation), got {nonlinear_activation}")
        params = nonlinear_activation_params or {"negative_slope": 0.1}
        self.negative_slope = params.get("negative_slope", 0.01)
        self.dilations = tuple(dilations)
        self.use_additional_convs = use_additional_convs

        def branch(dilation: int) -> nn.Sequential:
            return nn.Sequential(
                nn.LeakyReLU(self.negative_slope),
                Conv1d(channels, channels, kernel_size, dilation=dilation,
                       padding=(kernel_size - 1) // 2 * dilation, bias=bias,
                       use_weight_norm=use_weight_norm,
                       kernel_init=kernel_init, generator=generator))

        self.convs1 = nn.ModuleList([branch(d) for d in self.dilations])
        if use_additional_convs:
            self.convs2 = nn.ModuleList([branch(1) for _ in self.dilations])

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None
                ) -> torch.Tensor:
        """x ``(B, T, C)``; ``dtype`` is the compute dtype (default x's)."""
        dtype = dtype or x.dtype
        x = x.to(dtype)
        for i, dilation in enumerate(self.dilations):
            conv1 = self.convs1[i][1]
            if self.use_additional_convs:
                w1, b1 = conv1.kernel(dtype)
                w2, b2 = self.convs2[i][1].kernel(dtype)
                x = resblock_pair(x.contiguous(), w1, b1, w2, b2,
                                  dilation=dilation,
                                  negative_slope=self.negative_slope)
            else:
                x = x + conv1(self.convs1[i][0](x), dtype)
        return x
