"""Model FLOPs of the Gaddy & Klein Transformer's inversion training, from
its shapes (a multiply-add is 2 FLOPs). A row of the window, forward:

- the front end: three conv-BatchNorm ResBlocks (k 3 convolutions, a 1x1
  residual convolution in the first, whose input width differs);
- ``w_raw_in`` and ``w_out``;
- per encoder layer: the q, k, v and output projections, the FFN, and the
  banded attention: q k^T, P V and q E over the keys in the row's band
  (``band_pairs``: at most 2m - 1, fewer within m - 1 of either end).

A step is three forwards (the forward, and the backward's data and
weight gradients); normalisation, softmax and dropout are not counted."""

from __future__ import annotations

HEADS = 8
FFN = 3072
DISTANCE = 100


def band_pairs(length: int, m: int = DISTANCE) -> int:
    """(query, key) pairs with |k - q| < m in a window of ``length``."""
    return sum(min(i + m - 1, length - 1) - max(i - m + 1, 0) + 1
               for i in range(length))


def front_flops(gp: dict) -> float:
    """The ResBlocks' and the two outer projections' FLOPs a row."""
    d_in, hid = gp["in_channels"], gp["hidden_dim"]
    convs = 0.0
    for i in range(3):
        c_in = d_in if i == 0 else hid
        convs += 2.0 * 3 * c_in * hid + 2.0 * 3 * hid * hid
        if c_in != hid:
            convs += 2.0 * c_in * hid
    return convs + 2.0 * hid * hid + 2.0 * hid * gp["out_channels"]


def attention_flops(gp: dict, length: int) -> float:
    """One layer's banded attention over a window, forward: 3 products of
    2 d FLOPs per head and pair."""
    return 3 * 2.0 * gp["hidden_dim"] * band_pairs(length)


def layer_flops(gp: dict, length: int) -> float:
    """One encoder layer over a window, forward."""
    hid = gp["hidden_dim"]
    dense = 4 * 2.0 * hid * hid + 2 * 2.0 * hid * FFN
    return length * dense + attention_flops(gp, length)


def forward_flops(gp: dict, length: int) -> float:
    """The model over one window of ``length`` rows."""
    return length * front_flops(gp) + gp["elayers"] * layer_flops(gp,
                                                                  length)


def train_step_flops(model: dict, batch: int) -> float:
    """One training step on ``batch`` windows of ``batch_max_steps``."""
    return 3 * batch * forward_flops(model["generator_params"],
                                     model["batch_max_steps"])
