"""The fused residual pair and the residual block against the JAX package.

``resblock_pair_plain`` (what a CPU tensor runs, and the kernel's yardstick
on the card) is held against ``resblock_pair_reference`` and the Pallas
kernel in interpret mode at rtol/atol 1e-4, test_pallas_resblock.py's own
tolerance. The port's ``HiFiGANResidualBlock`` is held against the JAX block
on the same weights: with ``use_additional_convs`` each dilation is one pair,
which shows the pair decomposition is exact (f32, rtol/atol 1e-5). The
pair's gradients are held against ``jax.grad`` of the reference in float64
(1e-10), and the ``autograd.Function`` the card runs, driven with the plain
version standing in for the kernel, against plain autograd: before it the
kernel's output had no ``grad_fn`` and training stopped at the MRF.
``resblock_pair_backward_plain`` (the backward kernels' yardstick, and the
Function's backward on a CPU tensor) is held against autograd and
``jax.grad`` in float64 (1e-10) and gives just the gradients asked for.
The bf16 kernel's channel padding (``pad_channels``) is held exactly against
the unpadded pair and against the JAX reference, and ``_forward`` is shown
to take the bare launch where no gradient is wanted (the decode) and the
Function where one is."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.layers.residual import HiFiGANResidualBlock as JaxBlock
from articulatory_tpu.ops.pallas.resblock import (
    resblock_pair_pallas,
    resblock_pair_reference,
)
from articulatory_tpu.utils.torch_export import _Flat
from articulatory_tpu_torch.layers.residual import HiFiGANResidualBlock
from articulatory_tpu_torch.ops import resblock_pair as port
from articulatory_tpu_torch.ops.resblock_pair import (
    resblock_pair,
    resblock_pair_plain,
)

torch.set_num_threads(1)


def _pair_inputs(rng, t, c, k):
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    w1 = (rng.standard_normal((k, c, c)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((k, c, c)) * 0.1).astype(np.float32)
    b1 = rng.standard_normal((c,)).astype(np.float32)
    b2 = rng.standard_normal((c,)).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("dilation", [1, 3, 5])
def test_plain_matches_reference_and_pallas(k, dilation):
    # T = 256 is a whole number of the Pallas kernel's 128-row tiles
    args = _pair_inputs(np.random.default_rng(10 * k + dilation), 256, 32, k)
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(resblock_pair_reference(*jargs, dilation=dilation))
    pallas = np.asarray(resblock_pair_pallas(*jargs, dilation=dilation,
                                             t_tile=128, interpret=True))
    out = resblock_pair_plain(*map(torch.from_numpy, args),
                              dilation=dilation).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, pallas, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t,k,dilation", [(300, 11, 5), (7, 7, 3), (1, 3, 1)])
def test_plain_ragged_length_matches_reference(t, k, dilation):
    # lengths the Pallas kernel does not take (T % t_tile != 0), down to T = 1
    args = _pair_inputs(np.random.default_rng(t), t, 16, k)
    ref = np.asarray(resblock_pair_reference(*map(jnp.asarray, args),
                                             dilation=dilation))
    out = resblock_pair(*map(torch.from_numpy, args), dilation=dilation)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_cpu_tensor_launches_no_kernel():
    args = _pair_inputs(np.random.default_rng(0), 20, 8, 3)
    before = resblock_pair.launches
    resblock_pair(*map(torch.from_numpy, args), dilation=3)
    assert resblock_pair.launches == before


def _jax_block_and_port(kernel_size, dilations, additional, channels=12):
    rng = np.random.default_rng(kernel_size)
    x = rng.standard_normal((2, 40, channels)).astype(np.float32)
    jblock = JaxBlock(kernel_size=kernel_size, channels=channels,
                      dilations=dilations, use_additional_convs=additional)
    params = jax.device_get(
        jblock.init(jax.random.PRNGKey(kernel_size), jnp.asarray(x))["params"])
    flat = _Flat()
    for i in range(len(dilations)):
        flat.conv1d(f"convs1.{i}.1", params[f"convs1_{i}"])
        if additional:
            flat.conv1d(f"convs2.{i}.1", params[f"convs2_{i}"])
    block = HiFiGANResidualBlock(kernel_size=kernel_size, channels=channels,
                                 dilations=dilations,
                                 use_additional_convs=additional)
    block.load_state_dict({k: torch.tensor(v) for k, v in flat.sd.items()})
    return jblock, params, block, x


@pytest.mark.parametrize("kernel_size,dilations,additional", [
    (3, (1, 3, 5), True), (11, (1, 3, 5), True), (7, (1, 3), False)])
def test_residual_block_matches_jax(kernel_size, dilations, additional):
    jblock, params, block, x = _jax_block_and_port(kernel_size, dilations,
                                                   additional)
    ref = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = block(torch.from_numpy(x)).numpy()
        block.convs1[0][1].remove_weight_norm()  # cached kernel, same output
        again = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(again, out)


def test_residual_block_bf16_matches_jax():
    """bf16 compute (the hybrid interior): the kernel path rounds h and the
    output once each where XLA rounds after every op, so the bound is a few
    bf16 ulps of |x| <~ 4: atol 6e-2."""
    jblock, params, block, x = _jax_block_and_port(7, (1, 3, 5), True)
    jb = JaxBlock(kernel_size=7, channels=12, dilations=(1, 3, 5),
                  compute_dtype=jnp.bfloat16)
    ref = np.asarray(jb.apply({"params": params},
                              jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        out = block(torch.from_numpy(x), torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=6e-2)


@pytest.mark.parametrize("k,dilation", [(3, 1), (11, 5)])
def test_plain_grads_match_jax_grad_f64(k, dilation):
    args = [a.astype(np.float64) for a in
            _pair_inputs(np.random.default_rng(k), 37, 8, k)]
    cot = np.random.default_rng(1).standard_normal((2, 37, 8))
    with jax.enable_x64(True):
        want = jax.grad(lambda *a: jnp.sum(resblock_pair_reference(
            *a, dilation=dilation) * cot), argnums=tuple(range(5)))(
            *map(jnp.asarray, args))
        want = [np.asarray(w) for w in want]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    torch.sum(resblock_pair_plain(*leaves, dilation=dilation)
              * torch.from_numpy(cot)).backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-10,
                                   atol=1e-10)


# the recipe's (C, K, d) at small B and T; a T shorter than the halo; C not a
# multiple of 8 (the kernel's wrapper pads it)
BACKWARD_SHAPES = [(2, 23, 16, k, d) for k, d in ((3, 1), (7, 3), (11, 5))] + [
    (1, 5, 8, 11, 5), (2, 19, 12, 7, 3)]


@pytest.mark.parametrize("b,t,c,k,dilation", BACKWARD_SHAPES)
def test_backward_plain_matches_autograd_and_jax_grad(b, t, c, k, dilation):
    """``resblock_pair_backward_plain``'s formulas against autograd of the
    plain pair and ``jax.grad`` of the JAX reference, float64 (1e-10)."""
    rng = np.random.default_rng(100 * k + t)
    args = [a.astype(np.float64) for a in _pair_inputs(rng, t, c, k)]
    args[0] = args[0][:b]
    cot = rng.standard_normal(args[0].shape)
    with jax.enable_x64(True):
        want_jax = jax.grad(lambda *a: jnp.sum(resblock_pair_reference(
            *a, dilation=dilation) * cot), argnums=tuple(range(5)))(
            *map(jnp.asarray, args))
        want_jax = [np.asarray(w) for w in want_jax]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    want = torch.autograd.grad(resblock_pair_plain(*leaves, dilation=dilation),
                               leaves, torch.from_numpy(cot))
    got = port.resblock_pair_backward_plain(
        *map(torch.from_numpy, args), torch.from_numpy(cot),
        dilation=dilation)
    for g, w, wj in zip(got, want, want_jax):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(g.numpy(), wj, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("needs", list(itertools.product([False, True],
                                                         repeat=5)))
def test_backward_plain_gives_only_what_is_needed(needs, with_bias):
    """Each subset of ``needs`` (frozen weights: x alone) gives exactly
    those gradients, equal to the full backward's, None for the rest and
    for a missing bias."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a).double() for a in
                         _pair_inputs(np.random.default_rng(5), 17, 8, 7))
    if not with_bias:
        b1 = b2 = None
    gy = torch.randn(2, 17, 8, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(1))
    full = port.resblock_pair_backward_plain(x, w1, b1, w2, b2, gy,
                                             dilation=3)
    got = port.resblock_pair_backward_plain(x, w1, b1, w2, b2, gy,
                                            dilation=3, needs=needs)
    for g, f, need, v in zip(got, full, needs, (x, w1, b1, w2, b2)):
        if need and v is not None:
            torch.testing.assert_close(g, f, rtol=0, atol=0)
        else:
            assert g is None


def test_function_backward_on_cpu_runs_the_plain_backward(monkeypatch):
    """On a CPU tensor the Function's backward is
    ``resblock_pair_backward_plain``, asked for what autograd needs (x
    alone when the weights are frozen), and nothing is recomputed."""
    monkeypatch.setattr(port, "_launch", lambda x, w1, b1, w2, b2, d, sl: (
        resblock_pair_plain(x, w1, b1, w2, b2, dilation=d,
                            negative_slope=sl).detach()))
    calls = []
    plain = port.resblock_pair_backward_plain

    def spy(*args, **kwargs):
        calls.append(tuple(kwargs["needs"]))
        return plain(*args, **kwargs)

    monkeypatch.setattr(port, "resblock_pair_backward_plain", spy)
    monkeypatch.setattr(port, "recompute_grads", None)  # a call would raise
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in
                         _pair_inputs(np.random.default_rng(4), 13, 8, 3))
    leaf = x.clone().requires_grad_(True)
    y = port.ResblockPairFunction.apply(leaf, w1, b1, w2, b2, 1, 0.1)
    y.sum().backward()
    assert calls == [(True, False, False, False, False)]
    want = plain(x, w1, b1, w2, b2, torch.ones_like(x), dilation=1)[0]
    torch.testing.assert_close(leaf.grad, want)


@pytest.mark.parametrize("with_bias", [True, False])
def test_function_backward_matches_plain_autograd(monkeypatch, with_bias):
    monkeypatch.setattr(port, "_launch", lambda x, w1, b1, w2, b2, d, sl: (
        resblock_pair_plain(x, w1, b1, w2, b2, dilation=d,
                            negative_slope=sl).detach()))
    x, w1, b1, w2, b2 = (torch.from_numpy(a).double() for a in
                         _pair_inputs(np.random.default_rng(3), 29, 6, 7))
    if not with_bias:
        b1 = b2 = None
    cot = torch.randn(2, 29, 6, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(0))
    grads = []
    for fn in (lambda *a: port.ResblockPairFunction.apply(*a, 3, 0.1),
               lambda *a: resblock_pair_plain(*a, dilation=3)):
        leaves = [None if a is None else a.clone().requires_grad_(True)
                  for a in (x, w1, b1, w2, b2)]
        y = fn(*leaves)
        assert (type(y.grad_fn).__name__ == "ResblockPairFunctionBackward"
                ) == (not grads)
        torch.sum(torch.tanh(y) * cot).backward()
        grads.append([None if a is None else a.grad for a in leaves])
    for got, want in zip(*grads):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_function_reaches_every_generator_weight(monkeypatch):
    """Through the Function every convs1/convs2 weight of a residual block
    gets a gradient, and the block's input too."""
    monkeypatch.setattr(port, "_launch", lambda x, w1, b1, w2, b2, d, sl: (
        resblock_pair_plain(x, w1, b1, w2, b2, dilation=d,
                            negative_slope=sl).detach()))
    monkeypatch.setattr("articulatory_tpu_torch.layers.residual.resblock_pair",
                        lambda *a, dilation, negative_slope: (
                            port.ResblockPairFunction.apply(
                                *a, dilation, negative_slope)))
    _, _, block, x = _jax_block_and_port(3, (1, 3), True)
    xt = torch.from_numpy(x).requires_grad_(True)
    block(xt).square().sum().backward()
    assert xt.grad is not None and xt.grad.abs().sum() > 0
    for name, p in block.named_parameters():
        assert p.grad is not None and p.grad.abs().sum() > 0, name


@pytest.mark.parametrize("c,k,dilation", [(30, 7, 3), (12, 3, 1)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 6e-2)])
def test_padded_pair_is_exact(c, k, dilation, dtype, atol):
    """The bf16 kernel takes C a multiple of 16, so the wrapper zero-pads
    other C and slices the result: the padded pair, sliced, equals the
    unpadded one bit for bit, and its padded channels are zero. Against the
    JAX reference in f32 on the same (rounded) inputs: rtol/atol 1e-4 in
    f32; in bf16 the port rounds h and y where the f32 reference does not,
    a few bf16 ulps of |y| <~ 4 (atol 6e-2, as the bf16 block test)."""
    args = [torch.from_numpy(a).to(dtype) for a in
            _pair_inputs(np.random.default_rng(c + k), 41, c, k)]
    padded = port.pad_channels(*args, port.BF16_CHANNEL_MULTIPLE)
    assert padded[0].shape[2] % port.BF16_CHANNEL_MULTIPLE == 0
    assert padded[0].shape[2] - c < port.BF16_CHANNEL_MULTIPLE
    y = resblock_pair_plain(*args, dilation=dilation)
    yp = resblock_pair_plain(*padded, dilation=dilation)
    torch.testing.assert_close(yp[..., :c], y, rtol=0, atol=0)
    assert not yp[..., c:].any()
    ref = np.asarray(resblock_pair_reference(
        *(jnp.asarray(a.float().numpy()) for a in args), dilation=dilation))
    np.testing.assert_allclose(yp[..., :c].float().numpy(), ref,
                               rtol=1e-4 if dtype == torch.float32 else 0,
                               atol=atol)


def test_pad_channels_leaves_a_multiple_alone():
    args = [torch.from_numpy(a) for a in
            _pair_inputs(np.random.default_rng(5), 9, 32, 3)]
    assert all(p is a for p, a in zip(port.pad_channels(*args, 16), args))


def _plain_launch_counted(x, w1, b1, w2, b2, d, sl):
    resblock_pair.launches += 1
    return resblock_pair_plain(x, w1, b1, w2, b2, dilation=d,
                               negative_slope=sl).detach()


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode",
                                  "no_input_requires_grad", "grad"])
def test_forward_takes_function_only_for_grad(monkeypatch, mode):
    """Without grad mode, or with no input requiring a gradient, the pair is
    one bare launch (no grad_fn, no Function's host time); in grad mode with
    an input that requires one it goes through the Function. Either way one
    launch is counted."""
    monkeypatch.setattr(port, "_launch", _plain_launch_counted)
    args = [torch.from_numpy(a) for a in
            _pair_inputs(np.random.default_rng(7), 23, 8, 3)]
    leaves = [a.clone().requires_grad_(mode != "no_input_requires_grad")
              for a in args]
    context = {"no_grad": torch.no_grad,
               "inference_mode": torch.inference_mode}.get(
                   mode, torch.enable_grad)
    before = resblock_pair.launches
    with context():
        y = port._forward(*leaves, 3, 0.1)
    assert resblock_pair.launches == before + 1
    if mode == "grad":
        assert type(y.grad_fn).__name__ == "ResblockPairFunctionBackward"
    else:
        assert y.grad_fn is None
    torch.testing.assert_close(
        y.detach(), resblock_pair_plain(*args, dilation=3), rtol=0, atol=0)
