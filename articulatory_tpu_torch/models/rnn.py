"""BiGRU inversion model (port of ``articulatory_tpu/models/rnn.py``):
2 x BiGRU -> FC 128 -> BatchNorm -> FC out, over NLC ``(B, T, C)``.

The JAX package's ``GRULayer`` is torch's GRU (gate order r, z, n, separate
input and hidden biases, ``n = tanh(x_n + r * (W_hn h + b_hn))``, the reverse
direction over the flipped padded sequence), so each BiGRU layer here is an
``nn.GRU(bidirectional=True)``: cuDNN's fused recurrence on a card. Module
names are the reference's state-dict keys (``gru1``, ``gru2``, ``fc1.0``,
``bn``, ``fc2`` or ``fc2.0`` with ``use_tanh``, ``ar_model``, ``spk_fc``),
so reference torch pickles load straight in.

``in_channels`` is the GRU's input width after the AR and speaker features
are concatenated (the reference's meaning; the JAX package reads the width
from the input instead). With ``use_ar`` the ``PastFCEncoder`` reads a carry
of ``ar_input // out_channels`` frames of ``out_channels`` values.
``scan_unroll`` (TPU codegen) and ``ar_channels`` are accepted and
ignored. In ``train()`` mode ``dropout`` follows each GRU and the FC, and
the BatchNorm (``layers/norm.py``, flax's statistics) normalises with the
batch's, as the JAX module with ``train=True``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from articulatory_tpu_torch.layers.conv import Dense
from articulatory_tpu_torch.layers.norm import BatchNorm
from articulatory_tpu_torch.layers.past_encoder import PastFCEncoder


class StoredGRU(nn.GRU):
    """``nn.GRU`` whose weights may be stored as int8 (buffers
    ``<name>_int8``, ``<name>_scale``) or bfloat16 (``<name>_bf16``); the
    parameters stay float32 and hold the stored values, dequantized or
    upcast (the JAX package computes with them so: its GRU promotes the
    stored weights against the float32 input)."""

    def store(self, name: str, **buffers: torch.Tensor) -> None:
        """Keep ``buffers`` as ``<name>_<key>`` and write their value into
        parameter ``name``, in place (the flat weight buffer stays)."""
        for key, value in buffers.items():
            self.register_buffer(f"{name}_{key}", value)
        if "int8" in buffers:
            value = buffers["int8"].float() * buffers["scale"]
        else:
            value = buffers["bf16"].float()
        with torch.no_grad():
            getattr(self, name).copy_(value)


class BiGRU(nn.Module):
    def __init__(self, in_channels: int = 80, hidden_size: int = 256,
                 dropout: float = 0.3, out_channels: int = 1,
                 use_ar: bool = False, ar_input: int = 512,
                 ar_hidden: int = 256, ar_output: int = 128,
                 ar_channels: int | None = None, use_tanh: bool = False,
                 use_spk_emb: bool = False, spk_emb_size: int = 32,
                 spk_emb_hidden: int = 32, scan_unroll: int = 16,
                 seed: int = 0):
        super().__init__()
        del ar_channels, scan_unroll
        self.dropout = dropout
        generator = torch.Generator().manual_seed(seed)
        self.in_channels = in_channels
        self.use_ar = use_ar
        self.use_spk_emb = use_spk_emb
        if use_ar:
            self.ar_model = PastFCEncoder(ar_input, ar_hidden, ar_output,
                                          channels=out_channels,
                                          generator=generator)
        if use_spk_emb:
            self.spk_fc = Dense(spk_emb_size, spk_emb_hidden,
                                generator=generator)
        self.gru1 = StoredGRU(in_channels, hidden_size, batch_first=True,
                              bidirectional=True)
        self.gru2 = StoredGRU(2 * hidden_size, hidden_size, batch_first=True,
                              bidirectional=True)
        bound = hidden_size ** -0.5
        with torch.no_grad():  # torch's GRU init, from the seeded generator
            for p in (*self.gru1.parameters(), *self.gru2.parameters()):
                p.uniform_(-bound, bound, generator=generator)
        self.fc1 = nn.Sequential(Dense(2 * hidden_size, 128,
                                       generator=generator))
        self.bn = BatchNorm(128)
        fc2 = Dense(128, out_channels, generator=generator)
        self.fc2 = nn.Sequential(fc2, nn.Tanh()) if use_tanh else fc2

    def remove_weight_norm(self) -> None:
        """No weight norm here (``bin/decode.py`` calls it on every model)."""

    def forward(self, x: torch.Tensor, ar: torch.Tensor | None = None,
                spk: torch.Tensor | None = None,
                spk_id: torch.Tensor | None = None,
                ph: torch.Tensor | None = None) -> torch.Tensor:
        """``x`` (B, T, F); ``ar`` (B, ar_input // out_channels,
        out_channels); ``spk`` (B, spk_emb_size) -> (B, T, out_channels).
        ``spk_id`` and ``ph`` are accepted and unused, as in the
        reference."""
        del spk_id, ph
        b, t = x.shape[:2]
        if self.use_ar:
            feats = self.ar_model(ar)
            x = torch.cat([x, feats[:, None, :].expand(b, t, -1)], dim=-1)
        if self.use_spk_emb:
            feats = self.spk_fc(spk)
            x = torch.cat([x, feats[:, None, :].expand(b, t, -1)], dim=-1)
        x = self._drop(self.gru1(x)[0])
        x = self._drop(self.gru2(x)[0])
        x = self._drop(self.fc1(x))
        return self.fc2(self.bn(x))

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        if self.dropout > 0.0 and self.training:
            return F.dropout(x, self.dropout, training=True)
        return x
