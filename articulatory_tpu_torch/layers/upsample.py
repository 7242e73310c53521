"""Aux-feature upsampling for Parallel WaveGAN (port of
``articulatory_tpu/layers/upsample.py``), over NLC ``(B, T, C)``.

``UpsampleNetwork``: per scale, a stretch along time, then a
``(freq_axis_kernel_size, 2 * scale + 1)`` smoothing Conv2d over the
(features x time) image of one channel, no bias, initialised to
``1 / prod(kernel)``; optionally an activation. Keys ``up_layers.{i}``, the
Conv2d's index in the reference's ``[Stretch2d, Conv2d, (activation)]``
list per scale. As in the JAX package, the Conv2d trains its effective
``weight``; a state dict with the reference's weight-norm pair (``weight_g``
/ ``weight_v``, what the JAX package's exporter writes) is folded into it
on load.

``ConvInUpsampleNetwork``: an unpadded ``2 * aux_context_window + 1``
context Conv1d (``conv_in``) then ``upsample``.

``interpolate_mode`` stretches by ``nearest`` repetition or ``linear``
interpolation (``ops/interp.py``); only non-causal convs are ported.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from articulatory_tpu_torch.layers.activations import get_activation
from articulatory_tpu_torch.layers.conv import (
    Conv1d,
    Conv2d,
    weight_norm_weight,
)
from articulatory_tpu_torch.layers.residual import nearest_upsample, no_causal
from articulatory_tpu_torch.ops.interp import interpolate_linear


class _FoldedConv2d(Conv2d):
    """A plain Conv2d that folds a weight-norm pair it is loaded from."""

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        g = state_dict.pop(prefix + "weight_g", None)
        v = state_dict.pop(prefix + "weight_v", None)
        if g is not None and v is not None:
            state_dict[prefix + "weight"] = weight_norm_weight(g, v)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class UpsampleNetwork(nn.Module):
    def __init__(self, upsample_scales: Sequence[int],
                 nonlinear_activation: str | None = None,
                 nonlinear_activation_params: dict | None = None,
                 interpolate_mode: str = "nearest",
                 freq_axis_kernel_size: int = 1,
                 use_causal_conv: bool = False):
        super().__init__()
        no_causal(use_causal_conv)
        if interpolate_mode not in ("nearest", "linear"):
            raise ValueError(f"unsupported interpolate_mode "
                             f"{interpolate_mode!r} (supported: nearest, "
                             f"linear)")
        self.interpolate_mode = interpolate_mode
        if (freq_axis_kernel_size - 1) % 2:
            raise ValueError("freq_axis_kernel_size must be odd")
        self.scales = tuple(upsample_scales)
        self.act = (None if nonlinear_activation is None else get_activation(
            nonlinear_activation, nonlinear_activation_params or {}))
        stride = 2 if nonlinear_activation is None else 3
        self.up_layers = nn.ModuleDict()
        freq_pad = (freq_axis_kernel_size - 1) // 2
        for i, scale in enumerate(self.scales):
            kernel = (freq_axis_kernel_size, 2 * scale + 1)
            conv = _FoldedConv2d(1, 1, kernel, padding=(freq_pad, scale),
                                 bias=False)
            with torch.no_grad():
                conv.weight.fill_(1.0 / np.prod(kernel))
            self.up_layers[str(1 + i * stride)] = conv

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        for scale, conv in zip(self.scales, self.up_layers.values()):
            if self.interpolate_mode == "nearest":
                c = nearest_upsample(c, scale)  # the JAX stretch_time
            else:
                c = interpolate_linear(c, c.shape[1] * scale)
            # (B, T, C) -> an image (B, C, T, 1): features x time, 1 channel
            c = conv(c.transpose(1, 2)[..., None])[..., 0].transpose(1, 2)
            if self.act is not None:
                c = self.act(c)
        return c


class ConvInUpsampleNetwork(nn.Module):
    def __init__(self, upsample_scales: Sequence[int],
                 nonlinear_activation: str | None = None,
                 nonlinear_activation_params: dict | None = None,
                 interpolate_mode: str = "nearest",
                 freq_axis_kernel_size: int = 1, aux_channels: int = 80,
                 aux_context_window: int = 0, use_causal_conv: bool = False,
                 use_weight_norm: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        no_causal(use_causal_conv)
        self.conv_in = Conv1d(aux_channels, aux_channels,
                              2 * aux_context_window + 1, bias=False,
                              use_weight_norm=use_weight_norm,
                              kernel_init="kaiming_normal_relu",
                              generator=generator)
        self.upsample = UpsampleNetwork(
            upsample_scales, nonlinear_activation,
            nonlinear_activation_params, interpolate_mode,
            freq_axis_kernel_size)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return self.upsample(self.conv_in(c))
