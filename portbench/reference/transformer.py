"""Plain PyTorch reference of Gaddy & Klein's Transformer (``An Improved
Model for Voicing Silent Speech``, ACL 2021; github.com/dgaddy/
silent_speech ``transduction_model.py``, ``transformer.py``) as the
articulatory recipes use it for inversion: features (B, T, F) in, EMA
(B, T, out) out.

Functions of a state dict under the reference's torch parameter names:

- three conv-BatchNorm ResBlocks (k 3, padding 1; a 1x1 conv and a
  BatchNorm on the residual where the widths differ), in training mode
  (batch statistics, biased variance, eps 1e-5);
- ``w_raw_in``, then ``elayers`` post-norm encoder layers:
  ``norm1(x + drop(attn(x)))``, ``norm2(x + drop(linear2(drop(relu(
  linear1(x))))))``, LayerNorm eps 1e-5;
- self-attention with 8 heads and a learned relative table E ``(H, 2m -
  1, d)``: ``softmax(q k^T / sqrt(d) + q E[k - q])`` over the keys within
  distance ``m - 1`` (the published ``-1e8`` beyond it leaves those keys a
  probability of exactly 0 in float32), dropout on the probabilities;
- ``w_out``.

Attention runs in blocks of ``QUERY_BLOCK`` queries against a window of
``QUERY_BLOCK + 2m - 2`` keys (the keys outside ``[0, L)`` zero and
masked), so nothing of size L^2 is made. The relative term is the
Transformer-XL skew: ``q E^T`` ``(.., n, 2m - 1)`` padded to ``2m - 1 + n``
columns, flattened and cut to rows of ``2m - 2 + n``, which puts entry
``(i, r)`` at key ``i + r`` of the window; the banded keep mask is skewed
the same way.

Dropout masks are the training step's (``articulatory_tpu_torch/train/
gan.py::RandomDraws``, its documented scheme): for the pass ``tag`` at
step ``steps``, site ``<tag>/layers.<i>/<site>``, a bool mask drawn by
``bernoulli_(1 - p)`` on the device from a generator seeded by the first
8 bytes of ``sha256("<seed>/<steps>/None/<site>/0")`` (little-endian,
shifted right once).

``precision``: ``f32`` (TF32 off, ``hifigan.no_tf32`` around the caller's
step), ``f64`` for the tests, ``bf16`` (weights and activations in
bfloat16, the output in float32; the cell's control).
"""

from __future__ import annotations

import hashlib

import torch
import torch.nn.functional as F

QUERY_BLOCK = 200
HEADS = 8
FFN = 3072
DISTANCE = 100
DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


def parameter_shapes(gp: dict) -> dict:
    """name -> (shape, init) of the model's parameters and statistics;
    init is ``("uniform", bound)``, ``("normal", std)``, ``("ones",)`` or
    ``("zeros",)``: torch's defaults for the convolutions and linear
    layers, the published Xavier normals of the attention and
    ``d^-1/2`` of the relative table."""
    d_in, hid, out = gp["in_channels"], gp["hidden_dim"], gp["out_channels"]
    d = hid // HEADS
    shapes = {}

    def norm(prefix, n, stats):
        shapes[f"{prefix}.weight"] = ((n,), ("ones",))
        shapes[f"{prefix}.bias"] = ((n,), ("zeros",))
        if stats:
            shapes[f"{prefix}.running_mean"] = ((n,), ("zeros",))
            shapes[f"{prefix}.running_var"] = ((n,), ("ones",))
            shapes[f"{prefix}.num_batches_tracked"] = ((), ("zeros",))

    def linear(prefix, c_out, c_in, k=None):
        bound = (c_in * (k or 1)) ** -0.5
        shapes[f"{prefix}.weight"] = ((c_out, c_in) + ((k,) if k else ()),
                                      ("uniform", bound))
        shapes[f"{prefix}.bias"] = ((c_out,), ("uniform", bound))

    for i in range(3):
        p, c_in = f"conv_blocks.{i}", d_in if i == 0 else hid
        linear(f"{p}.conv1", hid, c_in, 3)
        norm(f"{p}.bn1", hid, True)
        linear(f"{p}.conv2", hid, hid, 3)
        norm(f"{p}.bn2", hid, True)
        if c_in != hid:
            linear(f"{p}.residual_path", hid, c_in, 1)
            norm(f"{p}.res_norm", hid, True)
    linear("w_raw_in", hid, hid)
    std_qkv = (2.0 / (d * (hid + HEADS))) ** 0.5
    std_o = (2.0 / (hid * (d + HEADS))) ** 0.5
    for i in range(gp["elayers"]):
        p = f"transformer.layers.{i}"
        for name in ("w_q", "w_k", "w_v"):
            shapes[f"{p}.self_attn.{name}"] = ((HEADS, hid, d),
                                               ("normal", std_qkv))
        shapes[f"{p}.self_attn.w_o"] = ((HEADS, d, hid), ("normal", std_o))
        shapes[f"{p}.self_attn.relative_positional.embeddings"] = (
            (HEADS, 2 * DISTANCE - 1, d, 1), ("normal", d ** -0.5))
        linear(f"{p}.linear1", FFN, hid)
        linear(f"{p}.linear2", hid, FFN)
        norm(f"{p}.norm1", hid, False)
        norm(f"{p}.norm2", hid, False)
    linear("w_out", out, hid)
    return shapes


def keep_mask(seed: int, steps: int, site: str, shape, p: float,
              device) -> torch.Tensor:
    """The training step's dropout keep mask for ``site`` at ``steps``."""
    key = f"{seed}/{steps}/None/{site}/0".encode()
    g = torch.Generator(device).manual_seed(
        int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1)
    return torch.empty(shape, dtype=torch.bool, device=device).bernoulli_(
        1.0 - p, generator=g)


def _batch_norm(w, prefix, x):
    """Training-mode BatchNorm over (B, C, T)."""
    mean = x.mean((0, 2), keepdim=True)
    var = (x - mean).square().mean((0, 2), keepdim=True)
    return ((x - mean) / torch.sqrt(var + 1e-5) * w[f"{prefix}.weight"][:, None]
            + w[f"{prefix}.bias"][:, None])


def _res_block(w, prefix, x):
    """(B, C, T) -> (B, hidden, T)."""
    def conv(name, v, pad):
        return F.conv1d(v, w[f"{prefix}.{name}.weight"],
                        w[f"{prefix}.{name}.bias"], padding=pad)

    y = F.relu(_batch_norm(w, f"{prefix}.bn1", conv("conv1", x, 1)))
    y = _batch_norm(w, f"{prefix}.bn2", conv("conv2", y, 1))
    res = x
    if f"{prefix}.residual_path.weight" in w:
        res = _batch_norm(w, f"{prefix}.res_norm", conv("residual_path", x, 0))
    return F.relu(y + res)


def _skew(t: torch.Tensor) -> torch.Tensor:
    """(.., n, W) -> (.., n, W - 1 + n): entry (i, r) moved to column i + r,
    zeros elsewhere."""
    n, w = t.shape[-2:]
    flat = F.pad(t, (0, n)).flatten(-2)[..., :n * (w + n - 1)]
    return flat.unflatten(-1, (n, w + n - 1))


def attention(q, k, v, table, keep=None, p: float = 0.0,
              block: int = QUERY_BLOCK) -> torch.Tensor:
    """q, k, v (B, H, L, d), table (H, W, d), keep (B, H, L, W) bool or None
    -> (B, H, L, d), block by block of queries."""
    length, d = q.shape[2], q.shape[3]
    w = table.shape[1]
    half = (w - 1) // 2
    kp, vp = (F.pad(t, (0, 0, half, half + block)) for t in (k, v))
    pos = torch.arange(-half, length + half + block, device=q.device)
    outs = []
    for q0 in range(0, length, block):
        n = min(block, length - q0)
        qb = q[:, :, q0:q0 + n]
        # window keys q0 - half .. q0 + n - 1 + half, as padded rows q0 ..
        kb, vb = kp[:, :, q0:q0 + n + w - 1], vp[:, :, q0:q0 + n + w - 1]
        inside = _skew(torch.ones(n, w, device=q.device)) > 0
        inside = inside & ((pos[q0:q0 + n + w - 1] >= 0)
                           & (pos[q0:q0 + n + w - 1] < length))[None, :]
        s = (qb @ kb.transpose(-1, -2)) * d ** -0.5 + _skew(
            torch.einsum("bhnd,hwd->bhnw", qb, table))
        prob = torch.softmax(s.masked_fill(~inside, float("-inf")), -1)
        if keep is not None:
            prob = prob * _skew(keep[:, :, q0:q0 + n].to(prob.dtype)) / (
                1.0 - p)
        outs.append(prob @ vb)
    return torch.cat(outs, 2)


def _layer_norm(w, prefix, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.weight"],
                        w[f"{prefix}.bias"], 1e-5)


def _encoder_layer(w, prefix, x, masks, p):
    """x (B, L, D); ``masks(site, shape)`` gives a keep mask, or None
    without dropout."""
    a = f"{prefix}.self_attn"
    q, k, v = (torch.einsum("btf,hfa->bhta", x, w[f"{a}.{n}"])
               for n in ("w_q", "w_k", "w_v"))
    table = w[f"{a}.relative_positional.embeddings"][..., 0]
    keep = masks("attention", (*q.shape[:3], table.shape[1]))
    o = torch.einsum("bhta,haf->btf", attention(q, k, v, table, keep, p),
                     w[f"{a}.w_o"])

    def drop(t, site):
        m = masks(site, t.shape)
        return t if m is None else t * m / (1.0 - p)

    x = _layer_norm(w, f"{prefix}.norm1", x + drop(o, "attention_out"))
    h = drop(F.relu(F.linear(x, w[f"{prefix}.linear1.weight"],
                             w[f"{prefix}.linear1.bias"])), "ffn_hidden")
    y = F.linear(h, w[f"{prefix}.linear2.weight"],
                 w[f"{prefix}.linear2.bias"])
    return _layer_norm(w, f"{prefix}.norm2", x + drop(y, "ffn_out"))


def forward(weights: dict, gp: dict, x: torch.Tensor, precision: str,
            seed: int | None = None, steps: int = 0,
            tag: str = "generator") -> torch.Tensor:
    """x (B, T, F) -> (B, T, out), float32 (float64 in ``f64``). With
    ``seed`` dropout at
    ``gp["dropout"]`` takes the step's masks (the draws' seed, the step and
    the pass's tag), else none."""
    dtype = DTYPES[precision]
    w = {k: v.to(dtype) for k, v in weights.items()
         if v.is_floating_point()}
    p = gp.get("dropout", 0.0)

    def masks(site, shape):
        if seed is None or p <= 0.0:
            return None
        return keep_mask(seed, steps, site, shape, p, x.device)

    h = x.to(dtype).transpose(1, 2)
    for i in range(3):
        h = _res_block(w, f"conv_blocks.{i}", h)
    h = F.linear(h.transpose(1, 2), w["w_raw_in.weight"], w["w_raw_in.bias"])
    for i in range(gp["elayers"]):
        prefix = f"transformer.layers.{i}"
        h = _encoder_layer(w, prefix, h, lambda site, shape, i=i: masks(
            f"{tag}/layers.{i}/{site}", shape), p)
    y = F.linear(h, w["w_out.weight"], w["w_out.bias"])
    return y if precision == "f64" else y.float()
