"""The port's MelGAN (``models/melgan.py``, ``MelGANResidualStack``) against
the JAX package's, on the same weights and inputs.

Narrow models (channels 32, two stacks, three scales of 16 channels) are
initialised in JAX and carried across by the port's converters, which are
held key for key and array for array against the JAX package's
``export_melgan_generator`` and ``export_melgan_msd``. Outputs (every
discriminator feature map) agree in float64 under ``jax.enable_x64`` to
1e-8 and in float32 to rtol 1e-4 / atol 1e-5."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.layers.residual import (
    MelGANResidualStack as JaxStack,
)
from articulatory_tpu.models.melgan import (
    MelGANDiscriminator as JaxDisc,
    MelGANGenerator as JaxGen,
    MelGANMultiScaleDiscriminator as JaxMSD,
)
from articulatory_tpu.utils.torch_export import (
    export_melgan_generator,
    export_melgan_msd,
)
from articulatory_tpu_torch.layers.residual import MelGANResidualStack
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.utils import weights

torch.set_num_threads(1)

GP = dict(in_channels=13, out_channels=1, kernel_size=7, channels=32,
          upsample_scales=[4, 2], stacks=2)
DP = dict(scales=2, channels=8, max_downsample_channels=32,
          downsample_scales=[4, 2])
TOL = {torch.float64: dict(rtol=1e-8, atol=1e-8),
       torch.float32: dict(rtol=1e-4, atol=1e-5)}


def _tuples(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _flat(tree):
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _flat(item)]
    return [tree]


def _compare(jax_module, params, port, inputs, dtype):
    """Apply both on ``inputs`` (numpy) in ``dtype``; compare every leaf."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    with jax.enable_x64(dtype == torch.float64):
        p = jax.tree.map(lambda a: jnp.asarray(a, np_dtype), params)
        want = jax.jit(jax_module.apply)(
            {"params": p}, *[jnp.asarray(x, np_dtype) for x in inputs])
        want = [np.asarray(w) for w in _flat(want)]
    port = port.to(dtype)
    with torch.no_grad():
        got = _flat(port(*[torch.tensor(x, dtype=dtype) for x in inputs]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL[dtype])


def _assert_same(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


@functools.cache
def _generator():
    gen = JaxGen(**_tuples(GP))
    c = np.random.default_rng(0).standard_normal((2, 12, 13))
    params = jax.device_get(jax.jit(gen.init)(
        jax.random.PRNGKey(0), jnp.asarray(c, jnp.float32))["params"])
    return gen, params, c


@functools.cache
def _msd():
    disc = JaxMSD(**_tuples(DP))
    x = np.random.default_rng(1).standard_normal((2, 500, 1)) * 0.3
    params = jax.device_get(jax.jit(disc.init)(
        jax.random.PRNGKey(1), jnp.asarray(x, jnp.float32))["params"])
    return disc, params, x


def test_generator_converter_matches_exporter():
    _, params, _ = _generator()
    _assert_same(weights.jax_melgan_generator_to_state_dict(params, GP),
                 export_melgan_generator(params, GP))


def test_msd_converter_matches_exporter():
    _, params, _ = _msd()
    _assert_same(weights.jax_melgan_msd_to_state_dict(params, DP),
                 export_melgan_msd(params, DP))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_generator_matches_jax(dtype):
    gen, params, c = _generator()
    port = build_model("MelGANGenerator", GP)
    port.load_state_dict(weights.jax_melgan_generator_to_state_dict(params,
                                                                    GP))
    _compare(gen, params, port, [c], dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_multi_scale_discriminator_matches_jax(dtype):
    disc, params, x = _msd()
    port = build_model("MelGANMultiScaleDiscriminator", DP)
    port.load_state_dict(weights.jax_melgan_msd_to_state_dict(params, DP))
    _compare(disc, params, port, [x], dtype)


def test_single_discriminator_matches_jax():
    dp = dict(channels=8, max_downsample_channels=32, downsample_scales=[4])
    disc = JaxDisc(**_tuples(dp))
    x = np.random.default_rng(2).standard_normal((2, 301, 1))
    params = jax.device_get(jax.jit(disc.init)(
        jax.random.PRNGKey(2), jnp.asarray(x, jnp.float32))["params"])
    port = build_model("MelGANDiscriminator", dp)
    port.load_state_dict(weights.jax_melgan_discriminator_to_state_dict(
        params, dp))
    _compare(disc, params, port, [x], torch.float64)


@pytest.mark.parametrize("dilation", [1, 3])
def test_residual_stack_matches_jax(dilation):
    stack = JaxStack(kernel_size=3, channels=8, dilation=dilation)
    x = np.random.default_rng(3).standard_normal((2, 20, 8))
    params = jax.device_get(jax.jit(stack.init)(
        jax.random.PRNGKey(3), jnp.asarray(x, jnp.float32))["params"])
    port = MelGANResidualStack(3, 8, dilation)
    sd = {}
    weights._conv1d(sd, "stack.2", params["conv_dilated"])
    weights._conv1d(sd, "stack.4", params["conv_out"])
    weights._conv1d(sd, "skip_layer", params["conv_skip"])
    port.load_state_dict(sd)
    for dtype in TOL:
        _compare(stack, params, port, [x], dtype)
