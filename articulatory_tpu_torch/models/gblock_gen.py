"""GAN-TTS / CARGAN-style GBlock generator (port of
``articulatory_tpu/models/gblock_gen.py``), over NLC ``(B, T, C)``.

Input conv -> one ``GBlock`` per ``g_scales`` entry on the reference's
fixed channel schedule (channels, channels, channels / 2 x 4, channels / 4
x 2, channels / 8 x 2) -> LeakyReLU(0.01) -> output conv -> tanh. With
``use_ar`` the ``PastFCEncoder`` vector is tiled over time and concatenated
to the features (``in_channels`` counts it); with ``use_spk_id`` the
speaker's embedding (``spk_emb_mat``, ``num_spk`` x ``spk_emb_size``)
through ``spk_fc`` (to ``in_channels``) is added to them at every frame.
Keys ``input_conv``, ``resamples.{i}``, ``output_conv.1``, ``ar_model``,
``spk_emb_mat``, ``spk_fc``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from articulatory_tpu_torch.layers.conv import (
    Conv1d,
    Dense,
    Embed,
    remove_weight_norm,
)
from articulatory_tpu_torch.layers.past_encoder import PastFCEncoder
from articulatory_tpu_torch.layers.residual import GBlock


class GBlockGenerator(nn.Module):
    def __init__(self, in_channels: int = 80, out_channels: int = 1,
                 channels: int = 512, kernel_size: int = 7,
                 g_scales: Sequence[int] = (8, 8, 2, 2),
                 g_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 use_weight_norm: bool = True, use_ar: bool = False,
                 ar_input: int = 512, ar_hidden: int = 256,
                 ar_output: int = 128, use_tanh: bool = True,
                 use_spk_id: bool = False, num_spk: int | None = None,
                 spk_emb_size: int = 32, seed: int = 0):
        super().__init__()
        if use_spk_id and num_spk is None:
            raise ValueError("use_spk_id needs num_spk")
        if kernel_size % 2 != 1:
            raise ValueError("Kernel size must be odd number.")
        if len(g_scales) != len(g_kernel_sizes):
            raise ValueError("g_scales and g_kernel_sizes differ in length")
        generator = torch.Generator().manual_seed(seed)
        ch = channels
        g_out = [ch, ch, ch // 2, ch // 2, ch // 2, ch // 2, ch // 4, ch // 4,
                 ch // 8, ch // 8]
        self.use_ar, self.use_tanh = use_ar, use_tanh
        self.use_spk_id = use_spk_id
        # with weight norm off the reference's post-norm N(0, 0.01) reset of
        # the input and output convs is effective
        kinit = "torch_default" if use_weight_norm else "normal:0.01"
        if use_ar:
            self.ar_model = PastFCEncoder(ar_input, ar_hidden, ar_output,
                                          generator=generator)
        self.input_conv = Conv1d(in_channels, channels, kernel_size,
                                 padding=(kernel_size - 1) // 2,
                                 use_weight_norm=use_weight_norm,
                                 kernel_init=kinit, generator=generator)
        blocks, c_in = [], channels
        for i, (scale, k) in enumerate(zip(g_scales, g_kernel_sizes)):
            blocks.append(GBlock(c_in, g_out[i], scale, k, use_weight_norm,
                                 generator=generator))
            c_in = g_out[i]
        self.resamples = nn.ModuleList(blocks)
        self.output_conv = nn.ModuleDict({"1": Conv1d(
            c_in, out_channels, kernel_size, padding=(kernel_size - 1) // 2,
            use_weight_norm=use_weight_norm, kernel_init=kinit,
            generator=generator)})
        if use_spk_id:  # built last, as in HiFiGANGenerator
            self.spk_emb_mat = Embed(num_spk, spk_emb_size, generator)
            self.spk_fc = Dense(spk_emb_size, in_channels, generator=generator)

    def forward(self, c: torch.Tensor, ar: torch.Tensor | None = None,
                spk_id: torch.Tensor | None = None,
                ph: torch.Tensor | None = None) -> torch.Tensor:
        """``ph`` is accepted and unused, as in the reference."""
        del ph
        if self.use_ar:
            feats = self.ar_model(ar)
            c = torch.cat([c, feats[:, None, :].expand(
                c.shape[0], c.shape[1], feats.shape[-1])], dim=-1)
        if self.use_spk_id:
            c = c + self.spk_fc(self.spk_emb_mat(spk_id))[:, None, :]
        c = self.input_conv(c)
        for block in self.resamples:
            c = block(c)
        c = self.output_conv["1"](F.leaky_relu(c, 0.01))
        return torch.tanh(c) if self.use_tanh else c

    def remove_weight_norm(self) -> None:
        remove_weight_norm(self)
