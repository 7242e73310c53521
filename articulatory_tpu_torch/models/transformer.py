"""Gaddy & Klein silent-speech Transformer (port of
``articulatory_tpu/models/transformer.py``), over ``(B, T, C)``.

[phoneme embedding] -> [kernel-2 front conv with ``extra_art``, T - 1] ->
3 conv-BatchNorm ``ResBlock``s -> ``w_raw_in`` -> ``elayers`` post-norm
encoder layers (8 heads, FFN 3072, learned relative positions to distance
100) -> ``w_out``. BatchNorm and dropout follow the module's ``train()`` /
``eval()`` mode (JAX's ``train`` argument); in training, ``forward(...,
draws=d, tag=t)`` draws layer i's dropout masks from ``d`` tagged
``<t>/layers.<i>/<site>`` (``layers/transformer.py``), else from torch's
global generator. ``use_tanh`` is accepted and
not applied, as in the reference and the JAX package. Keys
``conv_blocks.{i}``, ``w_raw_in``, ``transformer.layers.{i}``, ``w_out``,
``in_emb_mat``.
"""

from __future__ import annotations

import torch
from torch import nn

from articulatory_tpu_torch.layers.conv import (
    Conv1d,
    Dense,
    Embed,
    remove_weight_norm,
)
from articulatory_tpu_torch.layers.residual import ResBlock
from articulatory_tpu_torch.layers.transformer import TransformerEncoderLayer


class Transformer(nn.Module):
    def __init__(self, in_channels: int = 8, out_channels: int = 80,
                 elayers: int = 6, hidden_dim: int = 768,
                 dropout: float = 0.2, extra_art: bool = False,
                 use_ar: bool = False, ar_input: int = 512,
                 ar_hidden: int = 256, ar_output: int = 128,
                 use_tanh: bool = False, num_ph: int | None = None,
                 ph_emb_size: int = 8, layer_type: str = "default",
                 seed: int = 0):
        super().__init__()
        del use_ar, ar_input, ar_hidden, ar_output, use_tanh
        if layer_type != "default":
            raise ValueError(f"unsupported layer_type {layer_type!r}")
        generator = torch.Generator().manual_seed(seed)
        if num_ph is not None:
            self.in_emb_mat = Embed(num_ph, ph_emb_size, generator=generator)
            in_channels = ph_emb_size
        blocks: list[nn.Module] = []
        if extra_art:
            blocks.append(Conv1d(in_channels, hidden_dim, 2,
                                 use_weight_norm=True, generator=generator))
            in_channels = hidden_dim
        for i in range(3):
            blocks.append(ResBlock(in_channels if i == 0 else hidden_dim,
                                   hidden_dim, generator=generator))
        self.conv_blocks = nn.ModuleList(blocks)
        self.w_raw_in = Dense(hidden_dim, hidden_dim, generator=generator)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList([TransformerEncoderLayer(
            hidden_dim, 8, 3072, dropout, True, 100, generator=generator)
            for _ in range(elayers)])
        self.w_out = Dense(hidden_dim, out_channels, generator=generator)

    def forward(self, x: torch.Tensor, ar: torch.Tensor | None = None,
                spk_id: torch.Tensor | None = None,
                ph: torch.Tensor | None = None, draws=None,
                tag: str = "generator") -> torch.Tensor:
        """x (B, T, in_channels) features, or (B, T) phoneme ids with
        ``num_ph``; ``ar``, ``spk_id`` and ``ph`` are accepted and unused,
        as in the reference; ``draws`` and ``tag`` key the dropout masks
        -> (B, T', out_channels), T' = T - 1 with ``extra_art``."""
        del ar, spk_id, ph
        if hasattr(self, "in_emb_mat"):
            x = self.in_emb_mat(x)
        for block in self.conv_blocks:
            x = block(x)
        x = self.w_raw_in(x)
        for i, layer in enumerate(self.transformer.layers):
            x = layer(x, draws=draws, tag=f"{tag}/layers.{i}")
        return self.w_out(x)

    def remove_weight_norm(self) -> None:
        remove_weight_norm(self)
