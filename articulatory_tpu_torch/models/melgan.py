"""MelGAN generator and discriminators (port of
``articulatory_tpu/models/melgan.py``), over NLC ``(B, T, C)``.

``MelGANGenerator``: reflect-padded input conv -> per scale (activation,
ConvTranspose1d, ``stacks`` ``MelGANResidualStack``s with dilations
``stack_kernel_size ** j``) -> activation -> reflect-padded output conv ->
tanh. Its convs sit in ``melgan``, a dict keyed by their index in the
reference's ``nn.Sequential`` (``melgan.1``, ``melgan.3``, ...). With
``use_causal_conv`` (the JAX package's ``models/melgan.py:68-117``) the
input and output convs are ``CausalConv1d``s (zero left padding, as the
JAX package pads), the upsamplers ``CausalConvTranspose1d``s and the
stacks causal; the reference's causal ``nn.Sequential`` has no pad layers,
so the keys are ``melgan.0.conv``, ``melgan.{i}.deconv``, ...

``MelGANDiscriminator``: a reflect-padded k0 * k1 conv, grouped strided
convs (``groups = channels // 4``), then two convs; returns every layer's
output, the last the logits. Keys ``layers.0.1``, ``layers.{i}.0``,
``layers.{n + 2}``.

``MelGANMultiScaleDiscriminator``: ``scales`` discriminators with an
``AvgPool1d`` between them (``count_include_pad`` False by default, as
the JAX package's ``avg_pool1d``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from articulatory_tpu_torch.layers.activations import get_activation
from articulatory_tpu_torch.layers.conv import (
    CausalConv1d,
    CausalConvTranspose1d,
    Conv1d,
    ConvTranspose1d,
    remove_weight_norm,
)
from articulatory_tpu_torch.layers.residual import (
    MelGANResidualStack,
    pad_layer_to_mode,
)
from articulatory_tpu_torch.ops.conv import avg_pool1d


class MelGANGenerator(nn.Module):
    """``c`` (B, T, in_channels) -> (B, T * prod(upsample_scales),
    out_channels)."""

    def __init__(self, in_channels: int = 80, out_channels: int = 1,
                 kernel_size: int = 7, channels: int = 512, bias: bool = True,
                 upsample_scales: Sequence[int] = (8, 8, 2, 2),
                 stack_kernel_size: int = 3, stacks: int = 3,
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: dict | None = None,
                 pad: str = "ReflectionPad1d", pad_params: dict | None = None,
                 use_final_nonlinear_activation: bool = True,
                 use_weight_norm: bool = True, use_causal_conv: bool = False,
                 seed: int = 0):
        super().__init__()
        if channels < np.prod(upsample_scales):
            raise ValueError("channels must be >= prod(upsample_scales)")
        if channels % (2 ** len(upsample_scales)):
            raise ValueError("channels must be divisible by "
                             "2 ** len(upsample_scales)")
        if not use_causal_conv and (kernel_size - 1) % 2:
            raise ValueError("Not support even kernel size.")
        generator = torch.Generator().manual_seed(seed)
        act_params = nonlinear_activation_params or {"negative_slope": 0.2}
        self.act = get_activation(nonlinear_activation, act_params)
        self.use_final_nonlinear_activation = use_final_nonlinear_activation
        pad_mode = pad_layer_to_mode(pad)
        conv = dict(bias=bias, use_weight_norm=use_weight_norm,
                    generator=generator)

        def edge_conv(c_in: int, c_out: int) -> nn.Module:
            if use_causal_conv:
                return CausalConv1d(c_in, c_out, kernel_size, **conv)
            return Conv1d(c_in, c_out, kernel_size,
                          padding=(kernel_size - 1) // 2, pad_mode=pad_mode,
                          **conv)

        # the index of each conv in the reference's nn.Sequential: a pad
        # layer precedes the edge convs unless they are causal
        idx = 0 if use_causal_conv else 1
        layers = {idx: edge_conv(in_channels, channels)}
        idx += 1
        ch = channels
        for i, scale in enumerate(upsample_scales):
            out = channels // (2 ** (i + 1))
            idx += 1  # the activation
            layers[idx] = (
                CausalConvTranspose1d(ch, out, scale * 2, stride=scale,
                                      **conv) if use_causal_conv else
                ConvTranspose1d(ch, out, scale * 2, stride=scale,
                                padding=scale // 2 + scale % 2,
                                output_padding=scale % 2, **conv))
            idx += 1
            for j in range(stacks):
                layers[idx] = MelGANResidualStack(
                    stack_kernel_size, out, stack_kernel_size ** j, bias,
                    nonlinear_activation, act_params, pad, pad_params,
                    use_causal_conv=use_causal_conv,
                    use_weight_norm=use_weight_norm, generator=generator)
                idx += 1
            ch = out
        idx += 1 if use_causal_conv else 2  # the activation (and pad layer)
        layers[idx] = edge_conv(ch, out_channels)
        self.melgan = nn.ModuleDict({str(k): v for k, v in layers.items()})

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        modules = list(self.melgan.values())
        x = modules[0](c)
        for m in modules[1:-1]:
            upsample = isinstance(m, (ConvTranspose1d, CausalConvTranspose1d))
            x = m(self.act(x)) if upsample else m(x)
        x = modules[-1](self.act(x))
        return torch.tanh(x) if self.use_final_nonlinear_activation else x

    def remove_weight_norm(self) -> None:
        remove_weight_norm(self)


class MelGANDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 kernel_sizes: Sequence[int] = (5, 3), channels: int = 16,
                 max_downsample_channels: int = 1024, bias: bool = True,
                 downsample_scales: Sequence[int] = (4, 4, 4, 4),
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: dict | None = None,
                 pad: str = "ReflectionPad1d", pad_params: dict | None = None,
                 use_weight_norm: bool = True, seed: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        del pad_params
        if len(kernel_sizes) != 2 or any(k % 2 != 1 for k in kernel_sizes):
            raise ValueError("kernel_sizes must be two odd sizes")
        generator = generator or torch.Generator().manual_seed(seed)
        self.act = get_activation(nonlinear_activation,
                                  nonlinear_activation_params
                                  or {"negative_slope": 0.2})
        conv = dict(bias=bias, use_weight_norm=use_weight_norm,
                    generator=generator)
        k0 = int(np.prod(kernel_sizes))
        layers = [nn.ModuleDict({"1": Conv1d(
            in_channels, channels, k0, padding=(k0 - 1) // 2,
            pad_mode=pad_layer_to_mode(pad), **conv)})]
        in_chs = channels
        for scale in downsample_scales:
            out_chs = min(in_chs * scale, max_downsample_channels)
            layers.append(nn.ModuleDict({"0": Conv1d(
                in_chs, out_chs, scale * 10 + 1, stride=scale,
                padding=scale * 5, groups=in_chs // 4, **conv)}))
            in_chs = out_chs
        out_chs = min(in_chs * 2, max_downsample_channels)
        layers.append(nn.ModuleDict({"0": Conv1d(
            in_chs, out_chs, kernel_sizes[0],
            padding=(kernel_sizes[0] - 1) // 2, **conv)}))
        layers.append(Conv1d(out_chs, out_channels, kernel_sizes[1],
                             padding=(kernel_sizes[1] - 1) // 2, **conv))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        outs = []
        for layer in self.layers[:-1]:
            x = self.act(next(iter(layer.values()))(x))
            outs.append(x)
        outs.append(self.layers[-1](x))
        return outs


class MelGANMultiScaleDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 scales: int = 3, downsample_pooling: str = "AvgPool1d",
                 downsample_pooling_params: dict | None = None,
                 kernel_sizes: Sequence[int] = (5, 3), channels: int = 16,
                 max_downsample_channels: int = 1024, bias: bool = True,
                 downsample_scales: Sequence[int] = (4, 4, 4, 4),
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: dict | None = None,
                 pad: str = "ReflectionPad1d", pad_params: dict | None = None,
                 use_weight_norm: bool = True, seed: int = 0):
        super().__init__()
        del downsample_pooling  # AvgPool1d whatever its name, as in JAX
        generator = torch.Generator().manual_seed(seed)
        self.pool = downsample_pooling_params or {
            "kernel_size": 4, "stride": 2, "padding": 1,
            "count_include_pad": False}
        self.discriminators = nn.ModuleList([MelGANDiscriminator(
            in_channels, out_channels, kernel_sizes, channels,
            max_downsample_channels, bias, downsample_scales,
            nonlinear_activation, nonlinear_activation_params, pad,
            pad_params, use_weight_norm, generator=generator)
            for _ in range(scales)])

    def forward(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        outs = []
        for d in self.discriminators:
            outs.append(d(x))
            x = avg_pool1d(x, self.pool["kernel_size"], self.pool["stride"],
                           self.pool["padding"],
                           self.pool.get("count_include_pad", True))
        return outs
