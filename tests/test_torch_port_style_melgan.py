"""The port's StyleMelGAN (``models/style_melgan.py``, ``layers/tade.py``)
against the JAX package's, on the same weights and inputs.

Narrow models (channels 16, noise 8 upsampled x 16, upsample (2, 2, 1); a
discriminator of 8 channels over windows (32, 64, 128, 256) with PQMF bands
2, 4 and 8) are initialised in JAX and carried across by the port's
converters, held key for key and array for array against
``export_style_melgan_generator`` and
``export_style_melgan_discriminator``. The noise ``z`` is drawn with JAX
and handed to both; JAX's random window offsets are replaced (by patching
``jax.random.randint``) with fixed ones that the port is given too.
Outputs agree in float64 under ``jax.enable_x64`` to 1e-8 and in float32 to
rtol 1e-4 / atol 1e-5."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.layers.tade import (
    TADELayer as JaxTADE,
    TADEResBlock as JaxTADEResBlock,
    instance_norm_time as jax_instance_norm,
)
from articulatory_tpu.models.style_melgan import (
    StyleMelGANDiscriminator as JaxDisc,
    StyleMelGANGenerator as JaxGen,
)
from articulatory_tpu.ops import pqmf
from articulatory_tpu.utils.torch_export import (
    export_style_melgan_discriminator,
    export_style_melgan_generator,
)
from articulatory_tpu_torch.layers.tade import (
    TADELayer,
    TADEResBlock,
    instance_norm_time,
)
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.utils import weights

torch.set_num_threads(1)

GP = dict(in_channels=8, aux_channels=10, channels=16, kernel_size=9,
          noise_upsample_scales=[4, 4], upsample_scales=[2, 2, 1])
DP = dict(repeats=2, window_sizes=[32, 64, 128, 256],
          pqmf_params=[[1, None, None, None], [2, 62, 0.267, 9.0],
                       [4, 62, 0.142, 9.0], [8, 62, 0.07949, 9.0]],
          discriminator_params={
              "out_channels": 1, "kernel_sizes": [5, 3], "channels": 8,
              "max_downsample_channels": 32, "bias": True,
              "downsample_scales": [2, 2, 1],
              "nonlinear_activation": "LeakyReLU",
              "nonlinear_activation_params": {"negative_slope": 0.2},
              "pad": "ReflectionPad1d", "pad_params": {}})
OFFSETS = [3, 100, 17, 250, 0, 64, 191, 5]  # in [0, 512 - window)
TOL = {torch.float64: dict(rtol=1e-8, atol=1e-8),
       torch.float32: dict(rtol=1e-4, atol=1e-5)}


def _jax_kwargs(d):
    return {k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
            if isinstance(v, list) else v for k, v in d.items()}


def _np_dtype(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


@functools.cache
def _generator():
    gen = JaxGen(**_jax_kwargs(GP))
    rng = np.random.default_rng(0)
    c = rng.standard_normal((2, 16, 10))
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (2, 1, 8)))
    params = jax.device_get(jax.jit(gen.init)(
        jax.random.PRNGKey(0), jnp.asarray(c, jnp.float32),
        jnp.asarray(z))["params"])
    return gen, params, c, z


@functools.cache
def _discriminator():
    disc = JaxDisc(**_jax_kwargs(DP))
    x = np.random.default_rng(1).standard_normal((2, 512, 1)) * 0.3
    params = jax.device_get(jax.jit(disc.init)(
        {"params": jax.random.PRNGKey(1), "window": jax.random.PRNGKey(2)},
        jnp.asarray(x, jnp.float32))["params"])
    return disc, params, x


def _same(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


def test_converters_match_exporters():
    _, params, _, _ = _generator()
    _same(weights.jax_style_melgan_generator_to_state_dict(params, GP),
          export_style_melgan_generator(params, GP))
    _, params, _ = _discriminator()
    _same(weights.jax_style_melgan_discriminator_to_state_dict(params, DP),
          export_style_melgan_discriminator(params, DP))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_generator_matches_jax(dtype):
    gen, params, c, z = _generator()
    np_dtype = _np_dtype(dtype)
    with jax.enable_x64(dtype == torch.float64):
        p = jax.tree.map(lambda a: jnp.asarray(a, np_dtype), params)
        want = np.asarray(jax.jit(gen.apply)(
            {"params": p}, jnp.asarray(c, np_dtype), jnp.asarray(z, np_dtype)))
    port = build_model("StyleMelGANGenerator", GP).to(dtype)
    port.load_state_dict(
        weights.jax_style_melgan_generator_to_state_dict(params, GP))
    with torch.no_grad():
        got = port(torch.tensor(c, dtype=dtype), torch.tensor(z, dtype=dtype))
    assert got.shape == want.shape == (2, 16 * 4, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


def test_generator_inference_pads_and_trims():
    _, params, c, _ = _generator()
    port = build_model("StyleMelGANGenerator", GP)
    port.load_state_dict(
        weights.jax_style_melgan_generator_to_state_dict(params, GP))
    x = torch.tensor(c[:, :13], dtype=torch.float32)
    with torch.no_grad():
        a = port.inference(x, torch.Generator().manual_seed(3))
        b = port.inference(x, torch.Generator().manual_seed(3))
    assert a.shape == (2, 13 * 4, 1) and torch.equal(a, b)
    assert torch.isfinite(a).all()


def _fixed_randint(monkeypatch):
    queue = list(OFFSETS)

    def randint(key, shape, minval, maxval, *args, **kwargs):
        start = queue.pop(0)
        assert 0 <= start < maxval
        return jnp.asarray(start, jnp.int32)

    monkeypatch.setattr(jax.random, "randint", randint)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_discriminator_matches_jax(dtype, monkeypatch):
    disc, params, x = _discriminator()
    np_dtype = _np_dtype(dtype)
    _fixed_randint(monkeypatch)
    # the JAX package keeps its PQMF filters float32, which its float64
    # convs refuse: the same values in float64, as the port casts them
    filters = pqmf.pqmf_filterbanks
    monkeypatch.setattr(pqmf, "pqmf_filterbanks", lambda *a: tuple(
        h.astype(np_dtype) for h in filters(*a)))
    with jax.enable_x64(dtype == torch.float64):
        p = jax.tree.map(lambda a: jnp.asarray(a, np_dtype), params)
        want = jax.jit(disc.apply)({"params": p}, jnp.asarray(x, np_dtype),
                                   rngs={"window": jax.random.PRNGKey(3)})
        want = [np.asarray(w) for w in jax.tree.leaves(want)]
    port = build_model("StyleMelGANDiscriminator", DP).to(dtype)
    port.load_state_dict(
        weights.jax_style_melgan_discriminator_to_state_dict(params, DP))
    with torch.no_grad():
        got = port(torch.tensor(x, dtype=dtype), OFFSETS)
    got = [leaf for outs in got for leaf in outs]
    assert len(got) == len(want) == 8 * 6
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL[dtype])


def test_discriminator_checks_offsets():
    port = build_model("StyleMelGANDiscriminator", DP)
    x = torch.zeros(1, 512, 1)
    with pytest.raises(ValueError, match="outside"):
        port(x, [0] * 7 + [256])
    with pytest.raises(ValueError, match="must exceed"):
        port.window_bounds(256)


@pytest.mark.parametrize("block", [False, True])
def test_tade_layers_match_jax(block):
    rng = np.random.default_rng(2)
    x, c = rng.standard_normal((2, 6, 4)), rng.standard_normal((2, 6, 3))
    if block:
        jax_mod = JaxTADEResBlock(in_channels=4, aux_channels=3,
                                  kernel_size=3, upsample_factor=2,
                                  gated_function="sigmoid")
        port = TADEResBlock(4, 3, 3, upsample_factor=2,
                            gated_function="sigmoid")
    else:
        jax_mod = JaxTADE(in_channels=4, aux_channels=3, kernel_size=3,
                          upsample_factor=2)
        port = TADELayer(4, 3, 3, upsample_factor=2)
    params = jax.device_get(jax.jit(jax_mod.init)(
        jax.random.PRNGKey(4), jnp.asarray(x, jnp.float32),
        jnp.asarray(c, jnp.float32))["params"])
    sd = {}
    for tade in ("tade1", "tade2") if block else ("",):
        p = params[tade] if tade else params
        for conv in ("aux_conv", "gated_conv"):
            weights._conv1d(sd, f"{tade}.{conv}.0".lstrip("."), p[conv])
    if block:
        for conv in ("gated_conv1", "gated_conv2"):
            weights._conv1d(sd, conv, params[conv])
    port.load_state_dict(sd)
    for dtype, tol in TOL.items():
        np_dtype = _np_dtype(dtype)
        with jax.enable_x64(dtype == torch.float64):
            p = jax.tree.map(lambda a: jnp.asarray(a, np_dtype), params)
            want = jax.jit(jax_mod.apply)({"params": p},
                                          jnp.asarray(x, np_dtype),
                                          jnp.asarray(c, np_dtype))
        with torch.no_grad():
            got = port.to(dtype)(torch.tensor(x, dtype=dtype),
                                 torch.tensor(c, dtype=dtype))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    with jax.enable_x64(True):
        want = np.asarray(jax_instance_norm(jnp.asarray(x)))
    np.testing.assert_allclose(instance_norm_time(torch.tensor(x)).numpy(),
                               want, rtol=1e-12, atol=1e-12)
