"""``PastFCEncoder``: the CARGAN autoregressive-context MLP (port of
``articulatory_tpu/layers/past_encoder.py``).

The past samples ``(B, P, C)`` are flattened channel-major (all samples of
channel 0, then channel 1, ...), as the reference's ``x.reshape(B, -1)`` on
``(B, C, P)``, then run through 4 LeakyReLU(0.1) layers and a linear head.
The layers sit in ``model`` at indices 0, 2, 4, 6, 8, the reference's
``nn.Sequential`` keys.
"""

from __future__ import annotations

import torch
from torch import nn

from articulatory_tpu_torch.layers.conv import Dense


class PastFCEncoder(nn.Module):
    def __init__(self, input_len: int = 512, hidden_dim: int = 256,
                 output_dim: int = 128, generator: torch.Generator | None = None):
        super().__init__()
        dims = [input_len] + [hidden_dim] * 4
        layers: list[nn.Module] = []
        for i in range(4):
            layers += [Dense(dims[i], dims[i + 1], generator=generator),
                       nn.LeakyReLU(0.1)]
        layers.append(Dense(hidden_dim, output_dim, generator=generator))
        self.model = nn.Sequential(*layers)

    def forward(self, ar: torch.Tensor) -> torch.Tensor:
        """``(B, P, C)`` -> ``(B, output_dim)``."""
        return self.model(ar.transpose(1, 2).reshape(ar.shape[0], -1))
