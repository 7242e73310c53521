"""The f32 pair's 3xTF32 arithmetic against the JAX package, on the CPU.

On the card ``csrc/resblock_pair.cu`` runs the float32 pair on the tensor
cores: each operand is split into two tf32 values (``a = a_hi + a_lo``, round
to nearest to 10 mantissa bits) and each product is ``a_lo b_hi + a_hi b_lo +
a_hi b_hi`` with f32 sums. The card is not here, so numpy emulations of that
arithmetic are held against the JAX ``resblock_pair_reference`` in float64:
the three-product pair comes within 1e-5 of max |y| (the limit chip_smoke
holds the kernel to), a single tf32 product misses it, and the kernel's rule
of folding the tensor cores' (truncating) partial sums into f32 every
``kFoldSteps`` k steps is what keeps a C 256, K 11 convolution inside it.
The port's plain weight split (``split_tf32_plain``, the prep kernel's
yardstick) and its cache on the decode's frozen kernels are held here too.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.ops.pallas.resblock import resblock_pair_reference
from articulatory_tpu_torch.layers.conv import Conv1d, Dense
from articulatory_tpu_torch.ops import _build
from articulatory_tpu_torch.ops import resblock_pair as port

torch.set_num_threads(1)

F64_TOL = 1e-5  # chip_smoke's limit for the f32 kernel against float64


def _tf32(a: np.ndarray) -> np.ndarray:
    """Round to nearest tf32, ties away from zero (``cvt.rna.tf32.f32``)."""
    a = np.ascontiguousarray(a, np.float32)
    return ((a.view(np.uint32) + np.uint32(0x1000))
            & np.uint32(0xFFFFE000)).view(np.float32)


def _lrelu(v: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, v, np.float32(0.1) * v).astype(np.float32)


def _conv(a, w, b, dil, products):
    """SAME conv over (B, T, C) as one matmul per tap, f32 sums: with
    ``products`` 3 the 3xTF32 split, with 1 a single tf32 product."""
    k, t = w.shape[0], a.shape[1]
    pad = (k - 1) // 2 * dil
    ap = np.pad(a, ((0, 0), (pad, pad), (0, 0)))
    out = np.zeros(a.shape[:2] + (w.shape[2],), np.float32)
    for j in range(k):
        rows = ap[:, j * dil: j * dil + t]
        if products == 3:
            a_hi, w_hi = _tf32(rows), _tf32(w[j])
            a_lo, w_lo = _tf32(rows - a_hi), _tf32(w[j] - w_hi)
            out += a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi
        else:
            out += _tf32(rows) @ _tf32(w[j])
    return out + b


def _pair(x, w1, b1, w2, b2, dilation, products):
    h = _conv(_lrelu(x), w1, b1, dilation, products)
    return x + _conv(_lrelu(h), w2, b2, 1, products)


def _inputs(c, k, seed):
    """chip_smoke's scaling: weights N(0, 1 / (C K)), biases N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    scale = (1.0 / (c * k)) ** 0.5
    x = rng.standard_normal((2, 64, c)).astype(np.float32)
    w1 = (rng.standard_normal((k, c, c)) * scale).astype(np.float32)
    w2 = (rng.standard_normal((k, c, c)) * scale).astype(np.float32)
    b1 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


def _reference_f64(args, dilation):
    with jax.enable_x64(True):
        return np.asarray(resblock_pair_reference(
            *(jnp.asarray(a, jnp.float64) for a in args), dilation=dilation))


@pytest.mark.parametrize("k,dilation", [(3, 1), (7, 3), (11, 5)])
def test_three_tf32_products_hold_the_f64_limit(k, dilation):
    args = _inputs(32, k, seed=k)
    ref = _reference_f64(args, dilation)
    err = np.abs(_pair(*args, dilation, products=3) - ref).max()
    assert err <= F64_TOL * np.abs(ref).max()


@pytest.mark.parametrize("k,dilation", [(3, 1), (7, 3), (11, 5)])
def test_one_tf32_product_misses_the_f64_limit(k, dilation):
    """The gate tells 3xTF32 from plain TF32: one product keeps 11 bits of
    each operand, about 2e-4 of max |y| here."""
    args = _inputs(32, k, seed=k)
    ref = _reference_f64(args, dilation)
    err = np.abs(_pair(*args, dilation, products=1) - ref).max()
    assert err > F64_TOL * np.abs(ref).max()


def _kernel_fold_steps() -> int:
    """The forward's fold cadence, in the convolution code it shares with
    the backward (``csrc/pair_conv.cuh``)."""
    source = (_build.CSRC / "pair_conv.cuh").read_text()
    return int(re.search(r"constexpr int kFoldSteps = (\d+);", source)[1])


def _add_truncated(acc: np.ndarray, s: np.ndarray) -> np.ndarray:
    """acc + s rounded toward zero to f32, as the tensor cores' sums."""
    exact = acc.astype(np.float64) + s
    out = exact.astype(np.float32)
    over = np.abs(out.astype(np.float64)) > np.abs(exact)
    out[over] = np.nextafter(out[over], np.float32(0))
    return out


def _conv_truncating(a, w, dil, fold_steps):
    """One SAME conv over (T, C) as the kernel issues it: per k step of 8
    input channels the three tf32 products, each summed exactly and added
    to the running partial sum with truncation; with ``fold_steps`` the
    partial is folded into an f32 sum (rounded to nearest) every that many
    k steps, without it the whole depth goes into one truncating sum."""
    k, t, c = w.shape[0], a.shape[0], w.shape[1]
    pad = (k - 1) // 2 * dil
    ap = np.pad(a, ((pad, pad), (0, 0)))
    acc = np.zeros((t, w.shape[2]), np.float32)
    part = np.zeros_like(acc)
    steps = 0
    for j in range(k):
        rows = ap[j * dil: j * dil + t]
        a_hi, w_hi = _tf32(rows), _tf32(w[j])
        a_lo, w_lo = _tf32(rows - a_hi), _tf32(w[j] - w_hi)
        for k0 in range(0, c, 8):
            if fold_steps and steps == fold_steps:
                acc, part, steps = acc + part, np.zeros_like(part), 0
            ks = slice(k0, k0 + 8)
            for lhs, rhs in ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)):
                part = _add_truncated(part, lhs[:, ks].astype(np.float64)
                                      @ rhs[ks].astype(np.float64))
            steps += 1
    return acc + part


def test_fold_keeps_truncating_sums_inside_the_limit():
    """The deepest conv of the port (C 256, K 11, d 5: 2816 inputs a
    output): summed in one truncating sum it comes near 1e-5 of max |y|
    (on the card the pair without the fold missed the limit at this
    shape); folded every kFoldSteps k steps it stays well inside."""
    c, k, d = 256, 11, 5
    rng = np.random.default_rng(0)
    a = _lrelu(rng.standard_normal((24, c)).astype(np.float32))
    w = (rng.standard_normal((k, c, c)) / (c * k) ** 0.5).astype(np.float32)
    pad = (k - 1) // 2 * d
    ap = np.pad(a.astype(np.float64), ((pad, pad), (0, 0)))
    ref = sum(ap[j * d: j * d + 24] @ w[j].astype(np.float64)
              for j in range(k))
    scale = np.abs(ref).max()
    folded = np.abs(_conv_truncating(a, w, d, _kernel_fold_steps()) - ref)
    whole = np.abs(_conv_truncating(a, w, d, None) - ref)
    assert folded.max() <= F64_TOL / 2 * scale
    assert whole.max() >= 3 * folded.max()


def test_round_tf32_matches_numpy_and_ties_away_from_zero():
    rng = np.random.default_rng(3)
    v = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)
         ).astype(np.float32)
    torch.testing.assert_close(port.round_tf32(torch.from_numpy(v)),
                               torch.from_numpy(_tf32(v)), rtol=0, atol=0)
    # 1 + 2^-11 lies halfway between two tf32 values: it goes up, and its
    # negative down
    half = np.float32(1 + 2.0 ** -11)
    got = port.round_tf32(torch.tensor([half, -half]))
    assert got.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


@pytest.mark.parametrize("k,c", [(3, 32), (11, 24)])
def test_split_plain_is_exact_hi_lo_in_kernel_layout(k, c):
    """hi has its low 13 mantissa bits zero; hi + lo rebuilds w to 2^-20
    relative; both come out (tap, out, in), the K-major layout wgmma takes."""
    w = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (k, c, c)).astype(np.float32))
    split = port.split_tf32_plain(w)
    assert split.shape == (2, k, c, c) and split.is_contiguous()
    hi, lo = split
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    wt = w.transpose(1, 2)
    assert ((hi + lo - wt).abs() <= 2.0 ** -20 * wt.abs()).all()
    torch.testing.assert_close(port.split_tf32(w, w[:1])[1],
                               port.split_tf32_plain(w[:1]), rtol=0, atol=0)


def test_f32_pads_to_a_multiple_of_eight_exactly():
    """The f32 kernel takes C a multiple of 8: a padded pair, sliced,
    equals the unpadded one bit for bit."""
    args = [torch.from_numpy(a) for a in _inputs(13, 3, seed=5)]
    padded = port.pad_channels(*args, port.F32_CHANNEL_MULTIPLE)
    assert padded[0].shape[2] == 16
    y = port.resblock_pair_plain(*args, dilation=3)
    yp = port.resblock_pair_plain(*padded, dilation=3)
    torch.testing.assert_close(yp[..., :13], y, rtol=0, atol=0)
    assert not yp[..., 13:].any()


def test_check_rejects_wider_than_256_in_both_dtypes():
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(1, 4, 264, dtype=dtype)
        w = torch.zeros(3, 264, 264, dtype=dtype)
        with pytest.raises(ValueError, match="at most 256"):
            port._check(x, w, None, w, None, 1)


def test_split_is_cached_only_on_inference_tensors(monkeypatch):
    """The decode's kernels are inference tensors (folded under
    ``inference_mode``): their split is made once. Other weights (training
    refolds them every forward) are split at every call."""
    made = []

    def plain_split(w1, w2):
        made.append(1)
        return port.split_tf32_plain(w1), port.split_tf32_plain(w2)

    monkeypatch.setattr(port, "_split", plain_split)
    w1, w2 = torch.randn(3, 8, 8), torch.randn(5, 8, 8)
    for _ in range(2):
        port._weight_splits(w1, w2)
    assert len(made) == 2
    with torch.inference_mode():
        f1, f2 = w1.clone(), w2.clone()
    first = port._weight_splits(f1, f2)
    again = port._weight_splits(f1, f2)
    assert len(made) == 3 and all(a is b for a, b in zip(first, again))
    torch.testing.assert_close(first[0], port.split_tf32_plain(w1))


def test_frozen_conv_returns_the_same_kernel_every_call():
    """After ``remove_weight_norm`` every call returns the same tensors, the
    first included, so the split cached on them is made once."""
    conv = Conv1d(8, 8, 3, use_weight_norm=True)
    conv.remove_weight_norm()
    with torch.inference_mode():
        first = conv.kernel(torch.float32)
        again = conv.kernel(torch.float32)
    assert first[0] is again[0] and first[1] is again[1]


@pytest.mark.parametrize("layer", ["conv", "dense"])
def test_frozen_weights_are_derived_again_after_a_load(layer):
    """A frozen layer (a conv's kernel, a dense weight) keeps what it
    derived until ``load_state_dict`` gives it new weights."""
    def make(seed):
        generator = torch.Generator().manual_seed(seed)
        if layer == "conv":
            return Conv1d(4, 4, 3, use_weight_norm=True, generator=generator)
        return Dense(4, 4, generator=generator)

    frozen, other = make(0), make(1)
    if layer == "conv":
        frozen.remove_weight_norm()
    else:
        frozen.freeze()
    x = torch.randn(2, 5, 4, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        before = frozen(x)
        assert torch.equal(frozen(x), before)
        frozen.load_state_dict(other.state_dict())
        torch.testing.assert_close(frozen(x), other(x), rtol=0, atol=0)
