"""Spectral norm (``layers/conv.py::spectral_normalize``) against the JAX
package's stateless ``spectral_normalize`` (five power iterations from
``ones / sqrt(c_out)``, no gradient through the iteration): the weights it
gives in float64 to 1e-10, and a ``HiFiGANPeriodDiscriminator`` with
``use_spectral_norm`` (weight norm off), its feature maps and its
parameters' gradients of a seeded projection of them, in float64 to 1e-10
and 1e-8; the scale stack keeps ignoring the key, as both packages do."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.layers.conv import spectral_normalize as jax_normalize
from articulatory_tpu.models.hifigan import (
    HiFiGANPeriodDiscriminator as JaxPeriod,
)
from articulatory_tpu_torch.layers.conv import spectral_normalize
from articulatory_tpu_torch.models import build_model

torch.set_num_threads(1)

_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_llvm_disable_expensive_passes": True})
PERIOD = dict(period=3, channels=4, max_downsample_channels=8,
              downsample_scales=[3, 1], use_weight_norm=False,
              use_spectral_norm=True)


@pytest.mark.parametrize("shape,out_axis", [((5, 1, 4, 8), -1),
                                            ((3, 1, 16, 1), -1),
                                            ((7, 12, 6), 0)])
def test_spectral_normalize_matches_jax_f64(shape, out_axis):
    w = np.random.default_rng(0).standard_normal(shape)
    with jax.enable_x64(True):
        want = np.asarray(jax_normalize(jnp.asarray(w), out_axis=out_axis))
    got = spectral_normalize(torch.from_numpy(w), out_axis=out_axis)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


def test_period_discriminator_with_spectral_norm_matches_jax_f64():
    rng = np.random.default_rng(1)
    x = 0.3 * rng.standard_normal((2, 100, 1))  # reflect-pads to 102
    jm = JaxPeriod(**PERIOD)
    with jax.enable_x64(True):
        params = jax.device_get(jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64),
            _jit(jm.init)(jax.random.PRNGKey(0), x)["params"]))
        proj = [rng.standard_normal(o.shape) for o in jax.eval_shape(
            jm.apply, {"params": params}, x)]

        def outs_and_grads(p):
            def loss(p):
                outs = jm.apply({"params": p}, x)
                return sum(jnp.sum(o * w) for o, w in zip(outs, proj)), outs

            grads, outs = jax.grad(loss, has_aux=True)(p)
            return outs, grads

        want_outs, want_grads = jax.device_get(_jit(outs_and_grads)(params))
    model = build_model("HiFiGANPeriodDiscriminator", PERIOD).double()
    # JAX's Conv2d kernels are (Kh, Kw, C_in, C_out), torch's (C_out,
    # C_in, Kh, Kw); spectral norm keeps the key ``weight``
    model.load_state_dict({
        _key(layer, leaf): torch.from_numpy(np.ascontiguousarray(
            np.transpose(value, (3, 2, 0, 1)) if leaf == "w" else value))
        for layer, tree in params.items()
        for leaf, value in tree.items()})
    outs = model(torch.from_numpy(x))
    for got, want in zip(outs, want_outs):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-10)
    sum(torch.sum(o * torch.from_numpy(w)) for o, w in zip(outs, proj)
        ).backward()
    grads = dict(model.named_parameters())
    for layer, tree in want_grads.items():
        for leaf, value in tree.items():
            want = (np.transpose(value, (3, 2, 0, 1)) if leaf == "w"
                    else value)
            np.testing.assert_allclose(grads[_key(layer, leaf)].grad.numpy(),
                                       want, rtol=1e-8, atol=1e-8,
                                       err_msg=f"{layer} {leaf}")


def _key(layer, leaf):
    """The port's key of JAX's ``conv_<i>`` / ``output_conv`` leaf."""
    name = {"w": "weight", "b": "bias"}[leaf]
    if layer == "output_conv":
        return f"output_conv.{name}"
    return f"convs.{layer.split('_')[1]}.0.{name}"


def test_scale_discriminator_ignores_spectral_norm():
    kwargs = dict(channels=8, max_downsample_channels=16, max_groups=2)
    plain = build_model("HiFiGANScaleDiscriminator", kwargs)
    normed = build_model("HiFiGANScaleDiscriminator",
                         dict(kwargs, use_weight_norm=False,
                              use_spectral_norm=True))
    assert plain.state_dict().keys() == normed.state_dict().keys()
    x = torch.randn(1, 64, 1, generator=torch.Generator().manual_seed(0))
    for a, b in zip(plain(x), normed(x)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
