"""Residual blocks (port of ``articulatory_tpu/layers/residual.py``), over
NLC ``(B, T, C)``, with the reference's state-dict keys.

``HiFiGANResidualBlock``: per dilation, ``x = x + conv2(act(conv1(act(x))))``.
With ``use_additional_convs`` each dilation is exactly one fused residual
pair, ``ops/resblock_pair.resblock_pair`` (the CUDA kernel on a card, its
plain version on the CPU). Without it a branch is ``x + conv1(act(x))``, one
conv through ``ops/conv.py``. Keys ``convs1.{d}.1`` and ``convs2.{d}.1``
(index 0 is the activation).

The zoo's blocks run plain convs (the JAX package has no Pallas kernel for
them):

- ``MelGANResidualStack``: ``conv_out(act(conv_dilated(act(x)))) +
  skip_layer(x)``, reflect padding; keys ``stack.2``, ``stack.4``,
  ``skip_layer``; with ``use_causal_conv`` the dilated conv is a
  ``CausalConv1d`` (zero left padding, as the JAX package's), keys
  ``stack.1.conv``, ``stack.3``, ``skip_layer`` (the reference's causal
  ``nn.Sequential`` has no pad layer);
- ``WaveNetResidualBlock``: the gated ``tanh * sigmoid`` dilated conv with a
  1x1 aux conditioning, returning ``((out + x) * sqrt(0.5), skip)``; keys
  ``conv``, ``conv1x1_aux``, ``conv1x1_skip``, ``conv1x1_out``; with
  ``use_causal_conv`` the dilated conv is left-padded by ``(K - 1) *
  dilation`` (any K);
- ``ResBlock``: conv-BatchNorm (Gaddy & Klein), ``layers/norm.py``'s
  BatchNorm; keys ``conv1``, ``bn1``, ``conv2``, ``bn2``, ``residual_path``,
  ``res_norm``;
- ``GBlock``: GAN-TTS, nearest upsampling and dilations (1, 3) + (9, 27);
  keys ``conv1.{1,3}``, ``res1.0`` (shifted by one after an upsample
  layer), ``conv2.{1,3}``.
"""

from __future__ import annotations

from typing import Sequence

import math

import torch
import torch.nn.functional as F
from torch import nn

from articulatory_tpu_torch.layers.activations import get_activation
from articulatory_tpu_torch.layers.conv import CausalConv1d, Conv1d
from articulatory_tpu_torch.layers.norm import BatchNorm
from articulatory_tpu_torch.ops.resblock_pair import resblock_pair


def pad_layer_to_mode(pad: str) -> str:
    """Torch pad-layer class names -> ``Conv1d`` pad modes."""
    return {"ReflectionPad1d": "reflect", "ReplicationPad1d": "replicate",
            "ConstantPad1d": "zeros"}.get(pad, "zeros")


def nearest_upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """``torch.nn.Upsample(scale_factor=s)`` (nearest) over the time axis."""
    return x if scale == 1 else torch.repeat_interleave(x, scale, dim=1)


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


class MelGANResidualStack(nn.Module):
    def __init__(self, kernel_size: int = 3, channels: int = 32,
                 dilation: int = 1, bias: bool = True,
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: dict | None = None,
                 pad: str = "ReflectionPad1d", pad_params: dict | None = None,
                 use_causal_conv: bool = False, use_weight_norm: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        del pad_params
        self.act = get_activation(nonlinear_activation,
                                  nonlinear_activation_params
                                  or {"negative_slope": 0.2})
        conv = dict(bias=bias, use_weight_norm=use_weight_norm,
                    generator=generator)
        if use_causal_conv:
            # the reference's Sequential(act, CausalConv1d, act, conv)
            self.stack = nn.ModuleDict({
                "1": CausalConv1d(channels, channels, kernel_size,
                                  dilation=dilation, **conv),
                "3": Conv1d(channels, channels, 1, **conv)})
        else:
            if (kernel_size - 1) % 2:
                raise ValueError("Not support even kernel size.")
            self.stack = nn.ModuleDict({
                "2": Conv1d(channels, channels, kernel_size,
                            dilation=dilation,
                            padding=(kernel_size - 1) // 2 * dilation,
                            pad_mode=pad_layer_to_mode(pad), **conv),
                "4": Conv1d(channels, channels, 1, **conv)})
        self.skip_layer = Conv1d(channels, channels, 1, **conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dilated, out = self.stack.values()
        return out(self.act(dilated(self.act(x)))) + self.skip_layer(x)


class WaveNetResidualBlock(nn.Module):
    """``forward(x, c)`` -> (residual, skip); ``c`` the upsampled aux
    features or None (``aux_channels`` <= 0 builds no aux conv)."""

    def __init__(self, kernel_size: int = 3, residual_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64,
                 aux_channels: int = 80, dropout: float = 0.0,
                 dilation: int = 1, bias: bool = True,
                 use_causal_conv: bool = False, use_weight_norm: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not use_causal_conv and (kernel_size - 1) % 2:
            raise ValueError("Not support even kernel size.")
        self.dropout = dropout
        conv = dict(use_weight_norm=use_weight_norm,
                    kernel_init="kaiming_normal_relu", generator=generator)
        # causal: left padding only, so output t sees inputs up to t
        pad = (kernel_size - 1) * dilation
        self.conv = Conv1d(residual_channels, gate_channels, kernel_size,
                           dilation=dilation,
                           padding=(pad, 0) if use_causal_conv else pad // 2,
                           bias=bias, bias_init="zeros", **conv)
        if aux_channels > 0:
            self.conv1x1_aux = Conv1d(aux_channels, gate_channels, 1,
                                      bias=False, **conv)
        half = gate_channels // 2
        self.conv1x1_skip = Conv1d(half, skip_channels, 1, bias=bias,
                                   bias_init="zeros", **conv)
        self.conv1x1_out = Conv1d(half, residual_channels, 1, bias=bias,
                                  bias_init="zeros", **conv)

    def forward(self, x: torch.Tensor, c: torch.Tensor | None,
                deterministic: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
        residual = x
        if self.dropout > 0.0 and not deterministic:
            x = F.dropout(x, self.dropout, training=True)
        xa, xb = self.conv(x).chunk(2, dim=-1)
        if c is not None:
            ca, cb = self.conv1x1_aux(c).chunk(2, dim=-1)
            xa, xb = xa + ca, xb + cb
        x = torch.tanh(xa) * torch.sigmoid(xb)
        s = self.conv1x1_skip(x)
        return (self.conv1x1_out(x) + residual) * math.sqrt(0.5), s


class ResBlock(nn.Module):
    def __init__(self, num_ins: int, num_outs: int, stride: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = Conv1d(num_ins, num_outs, 3, padding=1, stride=stride,
                            generator=generator)
        self.bn1 = BatchNorm(num_outs)
        self.conv2 = Conv1d(num_outs, num_outs, 3, padding=1,
                            generator=generator)
        self.bn2 = BatchNorm(num_outs)
        if stride != 1 or num_ins != num_outs:
            self.residual_path = Conv1d(num_ins, num_outs, 1, stride=stride,
                                        generator=generator)
            self.res_norm = BatchNorm(num_outs)
        else:
            self.residual_path = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        res = x if self.residual_path is None else self.res_norm(
            self.residual_path(x))
        return F.relu(y + res)


class GBlock(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, upsample: int = 1,
                 kernel_size: int = 3, use_weight_norm: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("GBlock requires an odd kernel_size (even "
                             "kernels break the residual length match)")
        self.upsample = upsample
        off = 1 if upsample > 1 else 0  # the Upsample layer shifts the keys
        pad = (kernel_size - 1) // 2
        conv = dict(use_weight_norm=use_weight_norm, generator=generator)
        self.conv1 = nn.ModuleDict({
            str(1 + off): Conv1d(input_dim, output_dim, kernel_size,
                                 padding=pad, **conv),
            str(3 + off): Conv1d(output_dim, output_dim, kernel_size,
                                 dilation=3, padding=3 * pad, **conv)})
        self.res1 = nn.ModuleDict({str(off): Conv1d(input_dim, output_dim, 1,
                                                    **conv)})
        self.conv2 = nn.ModuleDict({
            "1": Conv1d(output_dim, output_dim, kernel_size, dilation=9,
                        padding=9 * pad, **conv),
            "3": Conv1d(output_dim, output_dim, kernel_size, dilation=27,
                        padding=27 * pad, **conv)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv1a, conv1b = self.conv1.values()
        y = nearest_upsample(F.relu(x), self.upsample)
        y = conv1b(F.relu(conv1a(y)))
        x = y + next(iter(self.res1.values()))(nearest_upsample(
            x, self.upsample))
        y = self.conv2["3"](F.relu(self.conv2["1"](F.relu(x))))
        return x + y
