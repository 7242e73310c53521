"""The scale-discriminator head against the JAX package.

``scale_disc_head_plain`` (what a CPU tensor runs, and the kernel's
yardstick on the card) is held against ``scale_disc_head_reference`` in
float64 (1e-10: the same sums in another order) and float32 (1e-5), against
the Pallas kernel in interpret mode at test_pallas_scale_disc_head.py's own
bf16-scale tolerances, and at the configs' stride 4 against the first two
feature maps of the JAX ``HiFiGANScaleDiscriminator``. Its gradients are
held against ``jax.grad`` of the reference in float64, and the
``autograd.Function`` the card runs is driven here with the plain version
standing in for the kernel, against plain autograd."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.models.hifigan import HiFiGANScaleDiscriminator
from articulatory_tpu.ops.pallas.scale_disc_head import (
    scale_disc_head_pallas,
    scale_disc_head_reference,
)
from articulatory_tpu_torch.ops import scale_disc_head as port
from articulatory_tpu_torch.ops.scale_disc_head import (
    scale_disc_head,
    scale_disc_head_plain,
)

torch.set_num_threads(1)


def _inputs(t, seed=0, batch=2, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, t, 1)) * 0.3
    w0 = rng.standard_normal((15, 1, 128)) * 0.1
    b0 = rng.standard_normal((128,)) * 0.01 if bias else None
    wg = rng.standard_normal((41, 32, 128)) * 0.05
    b1 = rng.standard_normal((128,)) * 0.01 if bias else None
    return x, w0, b0, wg, b1


def _torch(args, dtype=torch.float32):
    return [None if a is None else torch.tensor(a, dtype=dtype) for a in args]


@pytest.mark.parametrize("t", [2176, 900, 901])
def test_plain_matches_reference(t):
    args = _inputs(t)
    with jax.enable_x64(True):
        ref64 = scale_disc_head_reference(*map(jnp.asarray, args))
        ref64 = [np.asarray(r) for r in ref64]
    ref32 = [np.asarray(r) for r in scale_disc_head_reference(
        *(jnp.asarray(a, jnp.float32) for a in args))]
    out64 = scale_disc_head_plain(*_torch(args, torch.float64), stride=2)
    out32 = scale_disc_head_plain(*_torch(args), stride=2)
    for got, want in zip(out64, ref64):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)
    for got, want in zip(out32, ref32):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,th", [(2176, 544), (900, 256)])
def test_plain_matches_pallas_interpret(t, th):
    args = [None if a is None else a.astype(np.float32) for a in _inputs(t)]
    h0e, h0o, h1 = scale_disc_head_pallas(*args, th=th, interpret=True)
    h0 = np.stack([np.asarray(h0e), np.asarray(h0o)], axis=2).reshape(2, t, 128)
    out0, out1 = scale_disc_head_plain(*_torch(args), stride=2)
    np.testing.assert_allclose(out0.numpy(), h0, atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(out1.numpy(), np.asarray(h1), atol=6e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("t", [629, 302])
def test_stride4_matches_jax_scale_discriminator(t):
    """The configs' layer 1 runs at stride 4: the head is the JAX scale
    discriminator's first two feature maps."""
    x = (np.random.default_rng(t).standard_normal((2, t, 1)) * 0.3
         ).astype(np.float32)
    disc = HiFiGANScaleDiscriminator(downsample_scales=(4, 4, 4, 4, 1),
                                     max_downsample_channels=128)
    params = jax.device_get(disc.init(jax.random.PRNGKey(0),
                                      jnp.asarray(x))["params"])
    outs = disc.apply({"params": params}, jnp.asarray(x))
    l0, l1 = params["layer_0"], params["layer_1"]
    h0, h1 = scale_disc_head(*_torch((x, l0["w"], l0["b"], l1["w"], l1["b"])),
                             stride=4)
    assert h1.shape == (2, (t - 1) // 4 + 1, 128)
    np.testing.assert_allclose(h0.numpy(), np.asarray(outs[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h1.numpy(), np.asarray(outs[1]), rtol=1e-5,
                               atol=1e-5)


def _cotangents(t, stride, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, t, 128)),
            rng.standard_normal((2, (t - 1) // stride + 1, 128)))


def test_plain_grads_match_jax_grad_f64():
    t = 301
    args = _inputs(t)
    c0, c1 = _cotangents(t, 2)
    with jax.enable_x64(True):
        def loss(*a):
            h0, h1 = scale_disc_head_reference(*a)
            return jnp.sum(h0 * c0) + jnp.sum(h1 * c1)

        want = jax.grad(loss, argnums=tuple(range(5)))(
            *map(jnp.asarray, args))
        want = [np.asarray(w) for w in want]
    leaves = [a.requires_grad_(True) for a in _torch(args, torch.float64)]
    h0, h1 = scale_disc_head_plain(*leaves, stride=2)
    (torch.sum(h0 * torch.from_numpy(c0))
     + torch.sum(h1 * torch.from_numpy(c1))).backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.parametrize("stride,bias", [(4, True), (2, False)])
def test_function_backward_matches_plain_autograd(monkeypatch, stride, bias):
    """The card's ``autograd.Function`` with the plain version launched in
    the kernel's place: outputs carry its grad_fn and its recompute
    backward equals plain autograd."""
    monkeypatch.setattr(port, "_launch", lambda x, w0, b0, wg, b1, s, sl: tuple(
        h.detach() for h in scale_disc_head_plain(x, w0, b0, wg, b1, stride=s,
                                                  negative_slope=sl)))
    t = 157
    args = _torch(_inputs(t, bias=bias), torch.float64)
    c0, c1 = map(torch.from_numpy, _cotangents(t, stride))
    grads = []
    for fn in (lambda *a: port.ScaleDiscHeadFunction.apply(*a, stride, 0.1),
               lambda *a: scale_disc_head_plain(*a, stride=stride)):
        leaves = [None if a is None else a.clone().requires_grad_(True)
                  for a in args]
        h0, h1 = fn(*leaves)
        (torch.sum(h0 * c0) + torch.sum(h1.sin() * c1)).backward()
        grads.append([None if a is None else a.grad for a in leaves])
        names = type(h0.grad_fn).__name__, type(h1.grad_fn).__name__
        assert all(n.startswith("ScaleDiscHeadFunction") for n in names) == (
            len(grads) == 1)
    for got, want in zip(*grads):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_cpu_tensor_launches_no_kernel():
    before = scale_disc_head.launches
    scale_disc_head(*_torch(_inputs(40)), stride=4)
    assert scale_disc_head.launches == before


def test_rejects_other_devices():
    x = torch.zeros(1, 8, 1, device="meta")
    with pytest.raises(ValueError):
        scale_disc_head(x, x, None, x, None, stride=2)
