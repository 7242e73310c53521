"""Parallel WaveGAN generator and discriminators (port of
``articulatory_tpu/models/parallel_wavegan.py``), over NLC ``(B, T, C)``.

``ParallelWaveGANGenerator.forward(x, c)``: noise ``x`` (B, T, 1) and aux
features ``c`` (B, T' + 2 * aux_context_window, aux_channels), upsampled by
``upsample_net`` to T, through ``layers`` ``WaveNetResidualBlock``s
(dilation ``2 ** (layer % layers_per_stack)``); the skips summed times
``sqrt(1 / layers)`` -> ReLU -> 1x1 -> ReLU -> 1x1. Keys ``first_conv``,
``upsample_net``, ``conv_layers.{i}``, ``last_conv_layers.{1,3}``. The
noise is an argument: training draws it from a seeded ``torch.Generator``
(or takes the legacy collater's), decoding from ``noise_generator``.

``ParallelWaveGANDiscriminator``: ``layers`` dilated convs (keys
``conv_layers.{2 i}``). ``ResidualParallelWaveGANDiscriminator``: a WaveNet
stack without aux features (keys ``first_conv.0``, ``conv_layers.{i}``,
``last_conv_layers.{1,3}``); as in the JAX package, its dropout never runs
(the training step calls discriminators deterministically). Causal convs
are not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from articulatory_tpu_torch.layers.activations import get_activation
from articulatory_tpu_torch.layers.conv import Conv1d, remove_weight_norm
from articulatory_tpu_torch.layers.residual import (
    WaveNetResidualBlock,
    no_causal,
)
from articulatory_tpu_torch.layers.upsample import (
    ConvInUpsampleNetwork,
    UpsampleNetwork,
)

_KAIMING = dict(kernel_init="kaiming_normal_relu", bias_init="zeros")


class ParallelWaveGANGenerator(nn.Module):
    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 kernel_size: int = 3, layers: int = 30, stacks: int = 3,
                 residual_channels: int = 64, gate_channels: int = 128,
                 skip_channels: int = 64, aux_channels: int = 80,
                 aux_context_window: int = 2, dropout: float = 0.0,
                 bias: bool = True, use_weight_norm: bool = True,
                 use_causal_conv: bool = False,
                 upsample_conditional_features: bool = True,
                 upsample_net: str = "ConvInUpsampleNetwork",
                 upsample_params: dict | None = None, seed: int = 0):
        super().__init__()
        no_causal(use_causal_conv)
        if layers % stacks:
            raise ValueError("layers must be a multiple of stacks")
        generator = torch.Generator().manual_seed(seed)
        self.layers_per_stack = layers // stacks
        self.n_layers = layers
        self.aux_context_window = aux_context_window
        params = dict(upsample_params or {"upsample_scales": [4, 4, 4, 4]})
        self.upsample_factor = (int(np.prod(params["upsample_scales"]))
                                if upsample_conditional_features else 1)
        self.first_conv = Conv1d(in_channels, residual_channels, 1,
                                 use_weight_norm=use_weight_norm,
                                 generator=generator, **_KAIMING)
        self.upsample_net = None
        if upsample_conditional_features:
            params.pop("use_causal_conv", None)
            if upsample_net == "ConvInUpsampleNetwork":
                self.upsample_net = ConvInUpsampleNetwork(
                    aux_channels=aux_channels,
                    aux_context_window=aux_context_window,
                    use_weight_norm=use_weight_norm, generator=generator,
                    **params)
            elif upsample_net == "UpsampleNetwork":
                self.upsample_net = UpsampleNetwork(**params)
            else:
                raise ValueError(f"Unsupported upsample_net: {upsample_net}")
        self.conv_layers = nn.ModuleList([WaveNetResidualBlock(
            kernel_size, residual_channels, gate_channels, skip_channels,
            aux_channels, dropout, 2 ** (layer % self.layers_per_stack), bias,
            use_weight_norm=use_weight_norm, generator=generator)
            for layer in range(layers)])
        self.last_conv_layers = nn.ModuleDict({
            "1": Conv1d(skip_channels, skip_channels, 1,
                        use_weight_norm=use_weight_norm, generator=generator,
                        **_KAIMING),
            "3": Conv1d(skip_channels, out_channels, 1,
                        use_weight_norm=use_weight_norm, generator=generator,
                        **_KAIMING)})

    def forward(self, x: torch.Tensor, c: torch.Tensor | None
                ) -> torch.Tensor:
        if c is not None and self.upsample_net is not None:
            c = self.upsample_net(c)
            if c.shape[1] != x.shape[1]:
                raise ValueError(f"upsampled aux length {c.shape[1]} != "
                                 f"noise length {x.shape[1]}")
        x = self.first_conv(x)
        skips = 0.0
        for layer in self.conv_layers:
            x, h = layer(x, c, deterministic=not self.training)
            skips = skips + h
        skips = skips * math.sqrt(1.0 / self.n_layers)
        x = self.last_conv_layers["1"](F.relu(skips))
        return self.last_conv_layers["3"](F.relu(x))

    def inference(self, c: torch.Tensor,
                  noise_generator: torch.Generator | None = None
                  ) -> torch.Tensor:
        """Aux features ``c`` (B, T, aux_channels) -> (B, T * upsample, out):
        replicate-pads ``aux_context_window`` frames on both sides (the
        reference's ``ReplicationPad1d``) and draws the noise from
        ``noise_generator`` (a fresh ``torch.Generator`` seeded 0 by
        default, on ``c``'s device)."""
        if noise_generator is None:
            noise_generator = torch.Generator(c.device).manual_seed(0)
        noise = torch.randn((c.shape[0], c.shape[1] * self.upsample_factor, 1),
                            generator=noise_generator, device=c.device,
                            dtype=c.dtype)
        pad = self.aux_context_window
        if pad:
            c = F.pad(c.transpose(1, 2), (pad, pad), mode="replicate"
                      ).transpose(1, 2)
        return self.forward(noise, c)

    def remove_weight_norm(self) -> None:
        remove_weight_norm(self)


class ParallelWaveGANDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 kernel_size: int = 3, layers: int = 10,
                 conv_channels: int = 64, dilation_factor: int = 1,
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: dict | None = None,
                 bias: bool = True, use_weight_norm: bool = True,
                 seed: int = 0):
        super().__init__()
        if (kernel_size - 1) % 2 or dilation_factor <= 0:
            raise ValueError("odd kernel_size and a positive dilation_factor "
                             "only")
        generator = torch.Generator().manual_seed(seed)
        self.act = get_activation(nonlinear_activation,
                                  nonlinear_activation_params
                                  or {"negative_slope": 0.2})
        convs = {}
        c_in = in_channels
        for i in range(layers - 1):
            dilation = 1 if i == 0 else (
                i if dilation_factor == 1 else dilation_factor ** i)
            convs[str(2 * i)] = Conv1d(
                c_in, conv_channels, kernel_size,
                padding=(kernel_size - 1) // 2 * dilation, dilation=dilation,
                bias=bias, use_weight_norm=use_weight_norm,
                generator=generator, **_KAIMING)
            c_in = conv_channels
        convs[str(2 * (layers - 1))] = Conv1d(
            c_in, out_channels, kernel_size, padding=(kernel_size - 1) // 2,
            bias=bias, use_weight_norm=use_weight_norm, generator=generator,
            **_KAIMING)
        self.conv_layers = nn.ModuleDict(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = list(self.conv_layers.values())
        for conv in convs[:-1]:
            x = self.act(conv(x))
        return convs[-1](x)


class ResidualParallelWaveGANDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 kernel_size: int = 3, layers: int = 30, stacks: int = 3,
                 residual_channels: int = 64, gate_channels: int = 128,
                 skip_channels: int = 64, dropout: float = 0.0,
                 bias: bool = True, use_weight_norm: bool = True,
                 use_causal_conv: bool = False,
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: dict | None = None,
                 seed: int = 0):
        super().__init__()
        no_causal(use_causal_conv)
        if (kernel_size - 1) % 2 or layers % stacks:
            raise ValueError("odd kernel_size and layers a multiple of "
                             "stacks only")
        generator = torch.Generator().manual_seed(seed)
        self.act = get_activation(nonlinear_activation,
                                  nonlinear_activation_params
                                  or {"negative_slope": 0.2})
        per_stack = layers // stacks
        self.n_layers = layers
        self.first_conv = nn.ModuleDict({"0": Conv1d(
            in_channels, residual_channels, 1, use_weight_norm=use_weight_norm,
            generator=generator, **_KAIMING)})
        self.conv_layers = nn.ModuleList([WaveNetResidualBlock(
            kernel_size, residual_channels, gate_channels, skip_channels, -1,
            dropout, 2 ** (layer % per_stack), bias,
            use_weight_norm=use_weight_norm, generator=generator)
            for layer in range(layers)])
        self.last_conv_layers = nn.ModuleDict({
            "1": Conv1d(skip_channels, skip_channels, 1,
                        use_weight_norm=use_weight_norm, generator=generator,
                        **_KAIMING),
            "3": Conv1d(skip_channels, out_channels, 1,
                        use_weight_norm=use_weight_norm, generator=generator,
                        **_KAIMING)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.first_conv["0"](x))
        skips = 0.0
        for layer in self.conv_layers:
            x, h = layer(x, None)
            skips = skips + h
        skips = skips * math.sqrt(1.0 / self.n_layers)
        x = self.last_conv_layers["1"](self.act(skips))
        return self.last_conv_layers["3"](self.act(x))
