"""The f32 head's 3xTF32 arithmetic and its polyphase window, on the CPU.

On the card ``csrc/scale_disc_head.cu`` runs layer 1 of the float32 head on
the tensor cores: each operand is split into two tf32 values (``a = a_hi +
a_lo``, round to nearest to 10 mantissa bits), each k step (8 inputs of a
group at one tap) issues ``a_lo b_hi``, ``a_hi b_lo`` and ``a_hi b_hi`` into
a partial sum whose additions truncate, and the partial sum is folded into
f32 every ``kFoldSteps`` k steps. The card is not here, so a numpy emulation
of that arithmetic is held against the JAX ``scale_disc_head_reference`` in
float64: within 1e-5 of max |h1| (the limit chip_smoke holds the kernel
to), where a single tf32 product misses it. The port's plain weight split
(``split_weights_plain``, the prep kernel's yardstick) and the window's
polyphase index rule are held here too.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.ops.pallas.scale_disc_head import scale_disc_head_reference
from articulatory_tpu_torch.ops import _build
from articulatory_tpu_torch.ops import scale_disc_head as port

torch.set_num_threads(1)

F64_TOL = 1e-5  # chip_smoke's limit for the f32 kernel against float64
K1, PAD1, GROUPS, GROUP_IN = 41, 20, 4, 32


def _tf32(a: np.ndarray) -> np.ndarray:
    """Round to nearest tf32, ties away from zero (``cvt.rna.tf32.f32``)."""
    a = np.ascontiguousarray(a, np.float32)
    return ((a.view(np.uint32) + np.uint32(0x1000))
            & np.uint32(0xFFFFE000)).view(np.float32)


def _lrelu(v: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, v, np.float32(0.1) * v).astype(np.float32)


def _add_truncated(acc: np.ndarray, s: np.ndarray) -> np.ndarray:
    """acc + s rounded toward zero to f32, as the tensor cores' sums."""
    exact = acc.astype(np.float64) + s
    out = exact.astype(np.float32)
    over = np.abs(out.astype(np.float64)) > np.abs(exact)
    out[over] = np.nextafter(out[over], np.float32(0))
    return out


def _inputs(t, seed):
    """chip_smoke's scaling: x N(0, 0.09), w0 N(0, 1/15), wg N(0, 1/1312),
    biases N(0, 0.01); batch 2."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, t, 1)) * 0.3).astype(np.float32)
    w0 = (rng.standard_normal((15, 1, 128)) / 15 ** 0.5).astype(np.float32)
    b0 = (rng.standard_normal(128) * 0.1).astype(np.float32)
    wg = (rng.standard_normal((K1, GROUP_IN, 128)) / (K1 * GROUP_IN) ** 0.5
          ).astype(np.float32)
    b1 = (rng.standard_normal(128) * 0.1).astype(np.float32)
    return x, w0, b0, wg, b1


def _layer0(x, w0, b0):
    """h0 in f32, and h0 zero-padded by 20 rows each side (layer 1's own
    padding)."""
    t = x.shape[1]
    xp = np.pad(x[..., 0], ((0, 0), (7, 7)))
    acc = np.zeros((x.shape[0], t, 128), np.float32)
    for k in range(15):
        acc += xp[:, k:k + t, None] * w0[k, 0]
    h0 = _lrelu(acc + b0)
    return h0, np.pad(h0, ((0, 0), (PAD1, PAD1), (0, 0)))


def _layer1(h0p, wg, b1, stride, products, fold_steps):
    """Layer 1 as the kernel issues it, per k step (tap-major, 8 inputs of
    every group): with ``products`` 3 the three tf32 products summed exactly
    and each added to the partial sum with truncation, folded into an f32
    sum (rounded to nearest) every ``fold_steps`` k steps; with 1 a single
    tf32 product a k step, summed exactly in f64."""
    bsz, tp, _ = h0p.shape
    t1 = (tp - 2 * PAD1 - 1) // stride + 1
    acc = np.zeros((bsz, t1, 128), np.float32)
    part = np.zeros_like(acc)
    exact = np.zeros(acc.shape, np.float64)
    steps = 0
    for tap in range(K1):
        rows = h0p[:, tap: tap + stride * (t1 - 1) + 1: stride]
        a = rows.reshape(bsz, t1, GROUPS, GROUP_IN)
        w = wg[tap].reshape(GROUP_IN, GROUPS, GROUP_IN).transpose(1, 0, 2)
        a_hi, w_hi = _tf32(a), _tf32(w)
        a_lo, w_lo = _tf32(a - a_hi), _tf32(w - w_hi)
        for k0 in range(0, GROUP_IN, 8):
            ks = slice(k0, k0 + 8)

            def prod(lhs, rhs):
                return np.einsum("btgi,gio->btgo", lhs[..., ks].astype(np.float64),
                                 rhs[:, ks].astype(np.float64)
                                 ).reshape(bsz, t1, 128)

            if products == 1:
                exact += prod(a_hi, w_hi)
                continue
            if steps == fold_steps:
                acc, part, steps = acc + part, np.zeros_like(part), 0
            for lhs, rhs in ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)):
                part = _add_truncated(part, prod(lhs, rhs))
            steps += 1
    total = exact.astype(np.float32) if products == 1 else acc + part
    return _lrelu(total + b1)


def _kernel_fold_steps() -> int:
    source = (_build.CSRC / "scale_disc_head.cu").read_text()
    return int(re.search(r"constexpr int kFoldSteps = (\d+);", source)[1])


def _reference_f64(args, stride):
    """The JAX reference in float64. It runs layer 1 at stride 2; stride 4's
    rows are every other row of it (h0 row 4t + k - 20 = 2 (2t) + k - 20)."""
    with jax.enable_x64(True):
        h0, h1 = scale_disc_head_reference(
            *(jnp.asarray(a, jnp.float64) for a in args))
        h0, h1 = np.asarray(h0), np.asarray(h1)
    return h0, h1[:, ::stride // 2]


@pytest.mark.parametrize("stride,t", [(4, 301), (2, 157)])
def test_three_tf32_products_hold_the_f64_limit(stride, t):
    args = _inputs(t, seed=stride)
    ref0, ref1 = _reference_f64(args, stride)
    h0, h0p = _layer0(*args[:3])
    h1 = _layer1(h0p, args[3], args[4], stride, 3, _kernel_fold_steps())
    assert h1.shape == ref1.shape
    assert np.abs(h0 - ref0).max() <= F64_TOL * np.abs(ref0).max()
    assert np.abs(h1 - ref1).max() <= F64_TOL * np.abs(ref1).max()


@pytest.mark.parametrize("stride,t", [(4, 301), (2, 157)])
def test_one_tf32_product_misses_the_f64_limit(stride, t):
    """The gate tells 3xTF32 from plain TF32: one product keeps 11 bits of
    each operand."""
    args = _inputs(t, seed=stride)
    _, ref1 = _reference_f64(args, stride)
    _, h0p = _layer0(*args[:3])
    h1 = _layer1(h0p, args[3], args[4], stride, 1, None)
    assert np.abs(h1 - ref1).max() > F64_TOL * np.abs(ref1).max()


def test_fold_keeps_truncating_sums_inside_the_limit():
    """A group's depth is 1312 inputs x taps (164 k steps): summed in one
    truncating sum it comes to about the limit (1.1e-5 of max |h1| here);
    folded every kFoldSteps k steps it stays well inside."""
    args = _inputs(301, seed=4)
    _, ref1 = _reference_f64(args, 4)
    _, h0p = _layer0(*args[:3])
    scale = np.abs(ref1).max()
    folded = np.abs(_layer1(h0p, args[3], args[4], 4, 3,
                            _kernel_fold_steps()) - ref1).max()
    whole = np.abs(_layer1(h0p, args[3], args[4], 4, 3, None) - ref1).max()
    assert folded <= F64_TOL / 2 * scale
    assert whole >= 3 * folded


def test_split_plain_is_exact_hi_lo_in_kernel_layout():
    """float32: (2, 41, 128 out, 32 in), the K-major layout wgmma takes; hi
    is tf32(w) and lo tf32(w - hi), bit for bit, both with their low 13
    mantissa bits zero, and hi + lo rebuilds w to 2^-22 relative (lo keeps
    11 of the residual's up to 13 bits). bfloat16: the transpose alone."""
    wg = _inputs(8, seed=7)[3]
    split = port.split_weights_plain(torch.from_numpy(wg))
    assert split.shape == (2, K1, 128, GROUP_IN) and split.is_contiguous()
    hi, lo = split.numpy()
    wt = wg.transpose(0, 2, 1)
    np.testing.assert_array_equal(hi, _tf32(wt))
    np.testing.assert_array_equal(lo, _tf32(wt - _tf32(wt)))
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    rebuilt = hi.astype(np.float64) + lo
    assert (np.abs(rebuilt - wt) <= 2.0 ** -22 * np.abs(wt)).all()
    bf = torch.from_numpy(wg).to(torch.bfloat16)
    got = port.split_weights_plain(bf)
    assert got.shape == (1, K1, 128, GROUP_IN) and got.is_contiguous()
    torch.testing.assert_close(got[0], bf.transpose(1, 2), rtol=0, atol=0)


def test_split_on_cpu_launches_no_kernel():
    before = port.split_weights.launches
    wg = torch.from_numpy(_inputs(8, seed=8)[3])
    torch.testing.assert_close(port.split_weights(wg),
                               port.split_weights_plain(wg), rtol=0, atol=0)
    assert port.split_weights.launches == before


def _window(valid, stride):
    """The kernel's ``window()``: phases, rows a phase, and the span of h0
    rows layer 0 covers, for a block that keeps ``valid`` h1 rows."""
    taps = (valid - 1) * stride + K1
    owned = valid * stride + PAD1
    return min(stride, K1), valid + (K1 - 1) // stride, max(taps, owned)


def _polyphase(r, stride, rows):
    """Window row r (h0 row t0 s - 20 + r) at phase r mod s, row r div s:
    its index in the (phases x rows) window."""
    return (r % stride) * rows + r // stride


@pytest.mark.parametrize("stride,valid,t", [(1, 64, 200), (2, 128, 901),
                                            (4, 64, 2512), (5, 64, 700),
                                            (4, 128, 37), (64, 8, 300)])
def test_polyphase_rule_matches_direct_indexing(stride, valid, t):
    """Every block of a (T, s) sequence: layer 0's writes by the polyphase
    rule, then layer 1's reads by the kernel's addressing (tap k of row t
    at phase k mod s, row (t - t0) + k div s, rows past ``valid`` clamped),
    against h0 indexed directly (zero outside [0, T)). The reads stay inside
    the rows layer 0 wrote."""
    h0 = np.arange(1, t + 1, dtype=np.float64)  # h0 row g holds g + 1
    t1 = (t - 1) // stride + 1
    phases, rows, span = _window(valid, stride)
    for t0 in range(0, t1, valid):
        lo = t0 * stride - PAD1
        win = np.full(phases * rows, np.nan)
        for r in range(span):
            if r % stride < phases and r // stride < rows:
                g = lo + r
                win[_polyphase(r, stride, rows)] = h0[g] if 0 <= g < t else 0.0
        for lane_row in range(128 if valid > 64 else 64):
            row = min(lane_row, valid - 1)
            for k in range(K1):
                got = win[(k % stride) * rows + row + k // stride]
                if lane_row >= valid or t0 + row >= t1:
                    assert not np.isnan(got)  # read, result dropped
                    continue
                g = stride * (t0 + row) + k - PAD1
                assert got == (h0[g] if 0 <= g < t else 0.0)
