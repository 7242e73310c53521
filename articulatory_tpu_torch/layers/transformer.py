"""Transformer encoder layer with learned relative positions (Gaddy & Klein;
port of ``articulatory_tpu/layers/transformer.py``), over ``(B, L, D)``.

``relative_position_logits``: the per-head relative table ``(H, 2m - 1,
d)`` against the queries, gathered into absolute ``(q, k)`` indexing (the
distance clipped to ``m - 1``) with ``-1e8`` added where ``|k - q| >= m``,
as the JAX package does. It materialises ``(B, H, L, L)``: at B 16, 8
heads and L 1000 that is 512 MB per f32 tensor. No layer calls it; the
tests hold the banded attention against it.

``MultiHeadAttention``: ``w_q``, ``w_k``, ``w_v`` ``(H, D, d)``, ``w_o``
``(H, d, D)`` and ``relative_positional.embeddings`` ``(H, 2m - 1, d, 1)``
(the reference's keys and shapes). With relative positions the attention
is banded (each query sees the keys within distance ``m - 1``, exactly as
the ``-1e8`` mask leaves it) and runs through
``ops/banded_attention.py``: the kernels on a card, the plain query-block
version on the CPU and in float64 (the parity mode, whose sums the
kernels' float32 cannot hold), nothing of size L^2 either way. Without them it is dense softmax attention in plain torch ops
(the JAX package computes both in plain ``jnp``, outside Pallas). In
training, dropout acts on the probabilities.

Dropout runs in training mode only. Each mask is drawn whole, as a bool
keep mask (``keep_mask``): from ``draws`` where given (an object with
``keep(shape, p, like, tag)``, the training step's ``RandomDraws``), tagged
``<tag>/<site>`` for the layer's four sites (``attention``, the banded
``(B, H, L, 2m - 1)`` mask of the probabilities; ``attention_out``;
``ffn_hidden``; ``ffn_out``), so a test or a reference replays them; else
from ``generator`` (on the input's device), else from torch's global
generator.

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

from articulatory_tpu_torch import trace
from articulatory_tpu_torch.layers.conv import Dense, _Stored
from articulatory_tpu_torch.ops.banded_attention import (
    banded_attention,
    banded_attention_plain,
)


def keep_mask(shape, p: float, device,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """A bool mask of ``shape``, each entry True with probability 1 - p."""
    return torch.empty(shape, dtype=torch.bool, device=device).bernoulli_(
        1.0 - p, generator=generator)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: torch.Generator | None = None,
            keep: torch.Tensor | None = None) -> torch.Tensor:
    """Inverted dropout with the keep mask ``keep``, else one drawn from
    ``generator`` where given, else ``F.dropout``'s own."""
    if p <= 0.0 or not training:
        return x
    if keep is None and generator is None:
        return F.dropout(x, p, training=True)
    if keep is None:
        keep = keep_mask(x.shape, p, x.device, generator)
    return x * keep / (1.0 - p)


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
        self.n_head, self.d_qkv, self.dropout = n_head, d_qkv, dropout
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

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        """x ``(B, L, D)``; ``keep`` the keep mask of the probabilities
        (banded ``(B, H, L, 2m - 1)`` with relative positions, else
        ``(B, H, L, L)``), else drawn from ``generator`` in training."""
        q = torch.einsum("btf,hfa->bhta", x, self.weight_as("w_q", x.dtype))
        k = torch.einsum("btf,hfa->bhta", x, self.weight_as("w_k", x.dtype))
        v = torch.einsum("btf,hfa->bhta", x, self.weight_as("w_v", x.dtype))
        p = self.dropout if self.training else 0.0
        if self.relative_positional is not None:
            if p > 0.0 and keep is None:
                keep = keep_mask((*q.shape[:3], 2 * self.distance - 1), p,
                                 x.device, generator)
            table = self.relative_positional.weight_as("embeddings", x.dtype)
            attend = (banded_attention_plain if q.dtype == torch.float64
                      else banded_attention)
            o = attend(q, k, v, table[..., 0], keep if p > 0.0 else None, p)
        else:
            logits = torch.einsum("bhqa,bhka->bhqk", q, k) / (
                self.d_qkv ** 0.5)
            probs = dropout(torch.softmax(logits, dim=-1), p, p > 0.0,
                            generator, keep)
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

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None, draws=None,
                tag: str = "") -> torch.Tensor:
        """x ``(B, L, D)``; in training each dropout site's mask comes from
        ``draws`` (tagged ``<tag>/<site>``) where given, else from
        ``generator``."""
        p = self.dropout if self.training else 0.0

        def keep(shape, site):
            if p <= 0.0 or draws is None:
                return None
            return draws.keep(shape, p, x, f"{tag}/{site}")

        def drop(t, site):
            return dropout(t, p, True, generator, keep(t.shape, site))

        attn = self.self_attn
        with trace.span("attention"):
            a = attn(x, generator, keep(
                (x.shape[0], attn.n_head, x.shape[1],
                 2 * attn.distance - 1 if attn.relative_positional
                 is not None else x.shape[1]), "attention"))
        x = self.norm1(x + drop(a, "attention_out"))
        y = self.linear2(drop(F.relu(self.linear1(x)), "ffn_hidden"))
        return self.norm2(x + drop(y, "ffn_out"))
