"""The autoregressive-context encoders (port of
``articulatory_tpu/layers/past_encoder.py``): ``PastFCEncoder``, the
CARGAN MLP, and ``PastSeqEncoder``.

The past samples ``(B, P, C)`` are flattened channel-major (all samples of
channel 0, then channel 1, ...), as the reference's ``x.reshape(B, -1)`` on
``(B, C, P)``, then run through 4 LeakyReLU(0.1) layers and a linear head.
The layers sit in ``model`` at indices 0, 2, 4, 6, 8, the reference's
``nn.Sequential`` keys.

The first layer reads the whole flattened carry: ``input_len`` samples of
one channel for the a2w generator; for a w2a BiGRU, ``input_len //
channels`` frames of ``channels`` values (504 inputs at ``ar_input`` 512 and
12 EMA channels), the width the JAX package takes from the carry.

``PastSeqEncoder`` keeps the past's time axis: ``(B, P, 1)`` -> a
conv-BatchNorm ``ResBlock`` (``res0``) -> ``elayers`` post-norm encoder
layers of 8 heads with learned relative positions to distance 100
(``transformer.layers.{i}``, as the port's ``Transformer`` keys them) ->
``(B, P, output_dim)``. BatchNorm and dropout follow ``train()`` /
``eval()``; in training, ``forward(ar, generator=g)`` draws the dropout
masks from ``g``.
"""

from __future__ import annotations

import torch
from torch import nn

from articulatory_tpu_torch.layers.conv import Dense
from articulatory_tpu_torch.layers.residual import ResBlock
from articulatory_tpu_torch.layers.transformer import TransformerEncoderLayer


class PastFCEncoder(nn.Module):
    def __init__(self, input_len: int = 512, hidden_dim: int = 256,
                 output_dim: int = 128, channels: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [input_len // channels * channels] + [hidden_dim] * 4
        layers: list[nn.Module] = []
        for i in range(4):
            layers += [Dense(dims[i], dims[i + 1], generator=generator),
                       nn.LeakyReLU(0.1)]
        layers.append(Dense(hidden_dim, output_dim, generator=generator))
        self.model = nn.Sequential(*layers)

    def forward(self, ar: torch.Tensor) -> torch.Tensor:
        """``(B, P, C)`` -> ``(B, output_dim)``."""
        return self.model(ar.transpose(1, 2).reshape(ar.shape[0], -1))


class PastSeqEncoder(nn.Module):
    def __init__(self, output_dim: int = 128, dropout: float = 0.2,
                 elayers: int = 2, ffdim: int = 512,
                 generator: torch.Generator | None = None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        self.res0 = ResBlock(1, output_dim, generator=generator)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList([TransformerEncoderLayer(
            output_dim, 8, ffdim, dropout, True, 100, generator=generator)
            for _ in range(elayers)])

    def forward(self, ar: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``(B, P, 1)`` -> ``(B, P, output_dim)``."""
        x = self.res0(ar)
        for layer in self.transformer.layers:
            x = layer(x, generator)
        return x
