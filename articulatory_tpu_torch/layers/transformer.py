"""Transformer encoder layer with learned relative positions (Gaddy & Klein;
port of ``articulatory_tpu/layers/transformer.py``), over ``(B, L, D)``.

``relative_position_logits``: the per-head relative table ``(H, 2m - 1,
d)`` against the queries, gathered into absolute ``(q, k)`` indexing (the
distance clipped to ``m - 1``) with ``-1e8`` added where ``|k - q| >= m``,
as the JAX package does. It materialises ``(B, H, L, L)``: at B 16, 8
heads and L 1000 that is 512 MB per f32 tensor.

``MultiHeadAttention``: ``w_q``, ``w_k``, ``w_v`` ``(H, D, d)``, ``w_o``
``(H, d, D)`` and ``relative_positional.embeddings`` ``(H, 2m - 1, d, 1)``
(the reference's keys and shapes), softmax attention in plain torch ops
(the JAX package computes it in plain ``jnp``, outside Pallas), dropout on
the probabilities in training.

``TransformerEncoderLayer``: post-norm, ``norm1(x + dropout(attn(x)))``,
then ``norm2(x + dropout(linear2(dropout(relu(linear1(x))))))``.

The attention's weights and the relative table may be stored as int8 or
bfloat16 (``utils/quantize.py``) and are read in the input's dtype, as the
LayerNorms' scales and biases are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from articulatory_tpu_torch.layers.conv import Dense, _Stored


def relative_position_logits(q: torch.Tensor, table: torch.Tensor,
                             max_relative_pos: int) -> torch.Tensor:
    """q ``(B, H, L, d)``, table ``(H, 2m - 1, d)`` -> ``(B, H, L, L)``."""
    m, length = max_relative_pos, q.shape[2]
    rel_logits = torch.einsum("bhqd,hmd->bhqm", q, table)
    pos = torch.arange(length, device=q.device)
    rel = pos[None, :] - pos[:, None]  # k - q
    idx = rel.clamp(-(m - 1), m - 1) + (m - 1)
    gathered = torch.gather(rel_logits, 3,
                            idx.expand(*rel_logits.shape[:2], length, length))
    mask = torch.where(rel.abs() >= m, -1e8, 0.0).to(q.dtype)
    return gathered + mask


class _RelativePositional(_Stored):
    def __init__(self, n_head: int, max_relative_pos: int, d_qkv: int,
                 generator: torch.Generator):
        super().__init__()
        self.embeddings = nn.Parameter(torch.empty(
            n_head, 2 * max_relative_pos - 1, d_qkv, 1).normal_(
                0.0, d_qkv ** -0.5, generator=generator))


class MultiHeadAttention(_Stored):
    def __init__(self, d_model: int = 256, n_head: int = 4,
                 dropout: float = 0.1, relative_positional: bool = True,
                 relative_positional_distance: int = 100,
                 generator: torch.Generator | None = None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        d_qkv = d_model // n_head
        if d_qkv * n_head != d_model:
            raise ValueError("d_model must be a multiple of n_head")
        self.d_qkv, self.dropout = d_qkv, dropout
        self.distance = relative_positional_distance
        # torch xavier_normal_ on the 3-D tensors, as the reference
        std_qkv = (2.0 / (d_qkv * (d_model + n_head))) ** 0.5
        std_o = (2.0 / (d_model * (d_qkv + n_head))) ** 0.5

        def normal(shape, std):
            return nn.Parameter(torch.empty(shape).normal_(
                0.0, std, generator=generator))

        self.w_q = normal((n_head, d_model, d_qkv), std_qkv)
        self.w_k = normal((n_head, d_model, d_qkv), std_qkv)
        self.w_v = normal((n_head, d_model, d_qkv), std_qkv)
        self.w_o = normal((n_head, d_qkv, d_model), std_o)
        self.relative_positional = (
            _RelativePositional(n_head, self.distance, d_qkv, generator)
            if relative_positional else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = torch.einsum("btf,hfa->bhta", x, self.weight_as("w_q", x.dtype))
        k = torch.einsum("btf,hfa->bhta", x, self.weight_as("w_k", x.dtype))
        v = torch.einsum("btf,hfa->bhta", x, self.weight_as("w_v", x.dtype))
        logits = torch.einsum("bhqa,bhka->bhqk", q, k) / (self.d_qkv ** 0.5)
        if self.relative_positional is not None:
            table = self.relative_positional.weight_as("embeddings", x.dtype)
            logits = logits + relative_position_logits(q, table[..., 0],
                                                       self.distance)
        probs = torch.softmax(logits, dim=-1)
        if self.dropout > 0.0 and self.training:
            probs = F.dropout(probs, self.dropout, training=True)
        o = torch.einsum("bhqk,bhka->bhqa", probs, v)
        return torch.einsum("bhta,haf->btf", o, self.weight_as("w_o", x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose scale and bias are read in the input's dtype
    (bfloat16 storage)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, relative_positional: bool = True,
                 relative_positional_distance: int = 100,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout, relative_positional,
            relative_positional_distance, generator=generator)
        self.linear1 = Dense(d_model, dim_feedforward, generator=generator)
        self.linear2 = Dense(dim_feedforward, d_model, generator=generator)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        if self.dropout > 0.0 and self.training:
            return F.dropout(x, self.dropout, training=True)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self._drop(self.self_attn(x)))
        y = self.linear2(self._drop(F.relu(self.linear1(x))))
        return self.norm2(x + self._drop(y))
