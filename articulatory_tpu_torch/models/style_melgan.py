"""StyleMelGAN generator and discriminator (port of
``articulatory_tpu/models/style_melgan.py``), over NLC ``(B, T, C)``.

``StyleMelGANGenerator.forward(c, z)``: the noise ``z`` (B, T_z,
in_channels) is upsampled by ``noise_upsample`` (ConvTranspose1d +
activation per scale) to T_z * prod(noise_upsample_scales) frames, which
must equal the aux length T; then one ``TADEResBlock`` per
``upsample_scales`` entry modulates it with the aux features; output conv
-> tanh. ``z`` is an argument, as the JAX module's explicit ``z``: training
draws it from a seeded ``torch.Generator``, and ``inference`` draws it
from ``noise_generator`` after replicate-padding the aux features up to a
multiple of the noise upsampling (the output trimmed back). Keys
``noise_upsample.{2 i}``, ``blocks.{i}``, ``output_conv.0``.

``StyleMelGANDiscriminator.forward(x, offsets)``: ``repeats`` rounds over
``window_sizes``; each takes the window ``x[:, o:o + size]`` at the given
offset (one per window, each in ``[0, T - size)``, shared by the batch as
in the JAX package's ``randint``), splits it into PQMF subbands when
``pqmf_params`` asks, and scores it with that resolution's
``MelGANDiscriminator``. ``window_bounds(T)`` gives each offset's upper
bound; the training step draws them from its seeded generator. Keys
``discriminators.{i}``; the PQMF filters are not in the state dict.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from articulatory_tpu_torch.layers.activations import get_activation
from articulatory_tpu_torch.layers.conv import (
    Conv1d,
    ConvTranspose1d,
    remove_weight_norm,
)
from articulatory_tpu_torch.layers.tade import TADEResBlock
from articulatory_tpu_torch.models.melgan import MelGANDiscriminator
from articulatory_tpu_torch.ops.pqmf import PQMF


class StyleMelGANGenerator(nn.Module):
    def __init__(self, in_channels: int = 128, aux_channels: int = 80,
                 channels: int = 64, out_channels: int = 1,
                 kernel_size: int = 9, dilation: int = 2, bias: bool = True,
                 noise_upsample_scales: Sequence[int] = (11, 2, 2, 2),
                 noise_upsample_activation: str = "LeakyReLU",
                 noise_upsample_activation_params: dict | None = None,
                 upsample_scales: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2, 1),
                 upsample_mode: str = "nearest",
                 gated_function: str = "softmax",
                 use_weight_norm: bool = True, seed: int = 0):
        super().__init__()
        generator = torch.Generator().manual_seed(seed)
        self.in_channels = in_channels
        self.noise_upsample_factor = int(np.prod(noise_upsample_scales))
        self.upsample_factor = int(np.prod(upsample_scales))
        self.act = get_activation(noise_upsample_activation,
                                  noise_upsample_activation_params
                                  or {"negative_slope": 0.2})
        ups, c_in = {}, in_channels
        for i, scale in enumerate(noise_upsample_scales):
            ups[str(2 * i)] = ConvTranspose1d(
                c_in, channels, scale * 2, stride=scale,
                padding=scale // 2 + scale % 2, output_padding=scale % 2,
                bias=bias, use_weight_norm=use_weight_norm,
                generator=generator)
            c_in = channels
        self.noise_upsample = nn.ModuleDict(ups)
        self.blocks = nn.ModuleList([TADEResBlock(
            channels, aux_channels if i == 0 else channels, kernel_size,
            dilation, bias, scale, upsample_mode, gated_function,
            generator=generator) for i, scale in enumerate(upsample_scales)])
        self.output_conv = nn.ModuleList([Conv1d(
            channels, out_channels, kernel_size,
            padding=(kernel_size - 1) // 2, bias=bias,
            use_weight_norm=use_weight_norm, generator=generator)])

    def forward(self, c: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """aux ``c`` (B, T, aux_channels), noise ``z`` (B, T_z,
        in_channels) with T_z * prod(noise_upsample_scales) = T ->
        (B, T * prod(upsample_scales), out_channels)."""
        x = z
        for conv in self.noise_upsample.values():
            x = self.act(conv(x))
        aux = c
        for block in self.blocks:
            x, aux = block(x, aux)
        return torch.tanh(self.output_conv[0](x))

    def inference_padded_length(self, t: int) -> tuple[int, int]:
        """(noise frames, padded aux length) for a t-frame input."""
        frames = math.ceil(t / self.noise_upsample_factor)
        return frames, frames * self.noise_upsample_factor

    def inference(self, c: torch.Tensor,
                  noise_generator: torch.Generator | None = None
                  ) -> torch.Tensor:
        """Aux ``c`` (B, T, aux_channels) -> (B, T * prod(upsample_scales),
        out_channels): the aux replicate-padded to a multiple of the noise
        upsampling, the noise drawn from ``noise_generator`` (a fresh
        ``torch.Generator`` seeded 0 by default, on ``c``'s device), the
        output trimmed to T's length."""
        if noise_generator is None:
            noise_generator = torch.Generator(c.device).manual_seed(0)
        t = c.shape[1]
        frames, padded = self.inference_padded_length(t)
        if padded > t:
            c = F.pad(c.transpose(1, 2), (0, padded - t), mode="replicate"
                      ).transpose(1, 2)
        z = torch.randn((c.shape[0], frames, self.in_channels),
                        generator=noise_generator, device=c.device,
                        dtype=c.dtype)
        return self.forward(c, z)[:, : t * self.upsample_factor]

    def remove_weight_norm(self) -> None:
        remove_weight_norm(self)


_DEFAULT_DISC = {
    "out_channels": 1, "kernel_sizes": [5, 3], "channels": 16,
    "max_downsample_channels": 512, "bias": True,
    "downsample_scales": [4, 4, 4, 1], "nonlinear_activation": "LeakyReLU",
    "nonlinear_activation_params": {"negative_slope": 0.2},
    "pad": "ReflectionPad1d", "pad_params": {}}


class StyleMelGANDiscriminator(nn.Module):
    def __init__(self, repeats: int = 2,
                 window_sizes: Sequence[int] = (512, 1024, 2048, 4096),
                 pqmf_params: Sequence[Sequence] = (
                     (1, None, None, None), (2, 62, 0.26700, 9.0),
                     (4, 62, 0.14200, 9.0), (8, 62, 0.07949, 9.0)),
                 discriminator_params: dict | None = None,
                 use_weight_norm: bool = True, seed: int = 0):
        super().__init__()
        if len(window_sizes) != len(pqmf_params):
            raise ValueError("window_sizes and pqmf_params differ in length")
        sizes = [ws // p[0] for ws, p in zip(window_sizes, pqmf_params)]
        if any(s != sizes[0] for s in sizes):
            raise ValueError("every window must give the same subband length")
        generator = torch.Generator().manual_seed(seed)
        self.repeats = repeats
        self.window_sizes = tuple(window_sizes)
        base = dict(discriminator_params or _DEFAULT_DISC)
        self.discriminators = nn.ModuleList()
        self.pqmfs = nn.ModuleList()
        for pq in pqmf_params:
            params = dict(base, in_channels=pq[0])
            self.discriminators.append(MelGANDiscriminator(
                **params, use_weight_norm=use_weight_norm,
                generator=generator))
            self.pqmfs.append(PQMF(pq[0], pq[1], pq[2], pq[3]) if pq[0] != 1
                              else nn.Identity())

    def window_bounds(self, length: int) -> list[int]:
        """Each window offset's exclusive upper bound for a T-long input."""
        if length <= max(self.window_sizes):
            raise ValueError(
                f"input length {length} must exceed the largest random "
                f"window size {max(self.window_sizes)} (batch_max_steps too "
                f"small)")
        return [length - ws for ws in self.window_sizes] * self.repeats

    def forward(self, x: torch.Tensor, offsets: Sequence[int]
                ) -> list[list[torch.Tensor]]:
        bounds = self.window_bounds(x.shape[1])
        if len(offsets) != len(bounds) or any(
                not 0 <= o < b for o, b in zip(offsets, bounds)):
            raise ValueError(f"offsets {list(offsets)} outside the bounds "
                             f"{bounds}")
        outs, n = [], len(self.window_sizes)
        for i, start in enumerate(offsets):
            idx = i % n
            window = x[:, start:start + self.window_sizes[idx]]
            if isinstance(self.pqmfs[idx], PQMF):
                window = self.pqmfs[idx].analysis(window)
            outs.append(self.discriminators[idx](window))
        return outs
