"""The port's Parallel WaveGAN (``models/parallel_wavegan.py``,
``layers/upsample.py``, ``WaveNetResidualBlock``) against the JAX
package's, on the same weights and inputs, and its legacy noise-input
``Collater`` against JAX's.

Narrow models (4 layers in 2 stacks, residual 8, gate 16, skip 8, 13 aux
features, aux context 2, upsample (4, 2)) are initialised in JAX and
carried across by the port's converters, held key for key and array for
array against ``export_pwg_generator`` and ``export_pwg_discriminator``.
The upsampling Conv2d's weight norm g is computed from the weights in the
test's dtype (JAX keeps the effective weight, the exporter a (g, v) pair
whose g, computed in float32, moves a float64 forward by 6e-8).
The generator's noise is drawn with JAX and handed to both. Outputs agree
in float64 under ``jax.enable_x64`` to 1e-8 and in float32 to rtol 1e-4 /
atol 1e-5."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.data.collate import Collater as JaxCollater
from articulatory_tpu.layers.residual import WaveNetResidualBlock as JaxBlock
from articulatory_tpu.layers.upsample import (
    ConvInUpsampleNetwork as JaxConvIn,
    UpsampleNetwork as JaxUpsample,
)
from articulatory_tpu.models.parallel_wavegan import (
    ParallelWaveGANDiscriminator as JaxDisc,
    ParallelWaveGANGenerator as JaxGen,
    ResidualParallelWaveGANDiscriminator as JaxResDisc,
)
from articulatory_tpu.utils.torch_export import (
    export_pwg_discriminator,
    export_pwg_generator,
)
from articulatory_tpu_torch.data.collate import Collater
from articulatory_tpu_torch.layers.residual import WaveNetResidualBlock
from articulatory_tpu_torch.layers.upsample import (
    ConvInUpsampleNetwork,
    UpsampleNetwork,
)
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.utils import weights

torch.set_num_threads(1)

GP = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
          skip_channels=8, aux_channels=13, aux_context_window=2,
          upsample_params={"upsample_scales": [4, 2]})
DP = dict(layers=4, conv_channels=8)
RDP = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
           skip_channels=8)
TOL = {torch.float64: dict(rtol=1e-8, atol=1e-8),
       torch.float32: dict(rtol=1e-4, atol=1e-5)}


def _jax_kwargs(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _cast(params, dtype):
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return jax.tree.map(lambda a: np.asarray(a, np_dtype), params)


def _load(port, state_dict, dtype):
    """``port`` in ``dtype`` holding ``state_dict`` (converted from weights
    cast to ``dtype``: the PWG Conv2d's g is computed from them)."""
    port.to(dtype).load_state_dict(state_dict)
    return port


def _compare(jax_module, params, port, inputs, dtype, **kwargs):
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    with jax.enable_x64(dtype == torch.float64):
        p = jax.tree.map(lambda a: jnp.asarray(a, np_dtype), params)
        want = jax.jit(functools.partial(jax_module.apply, **kwargs))(
            {"params": p}, *[jnp.asarray(x, np_dtype) for x in inputs])
        want = [np.asarray(w) for w in jax.tree.leaves(want)]
    port = port.to(dtype)
    with torch.no_grad():
        got = port(*[torch.tensor(x, dtype=dtype) for x in inputs])
    got = [got] if torch.is_tensor(got) else list(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL[dtype])


def _assert_same(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


def _init(module, *inputs):
    return jax.device_get(jax.jit(module.init)(
        jax.random.PRNGKey(0), *[jnp.asarray(x, jnp.float32)
                                 for x in inputs])["params"])


@functools.cache
def _generator():
    gen = JaxGen(**_jax_kwargs(GP))
    rng = np.random.default_rng(0)
    c = rng.standard_normal((2, 10 + 4, 13))
    # the noise drawn with JAX, handed to both packages
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (2, 80, 1)))
    return gen, _init(gen, z, c), z, c


def test_generator_converter_matches_exporter():
    _, params, _, _ = _generator()
    _assert_same(weights.jax_pwg_generator_to_state_dict(params, GP),
                 export_pwg_generator(params, GP))


def test_discriminator_converter_matches_exporter():
    disc = JaxDisc(**DP)
    params = _init(disc, np.zeros((1, 64, 1)))
    _assert_same(weights.jax_pwg_discriminator_to_state_dict(params, DP),
                 export_pwg_discriminator(params, DP))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_generator_matches_jax(dtype):
    gen, params, z, c = _generator()
    port = _load(build_model("ParallelWaveGANGenerator", GP).eval(),
                 weights.jax_pwg_generator_to_state_dict(
                     _cast(params, dtype), GP), dtype)
    _compare(gen, params, port, [z, c], dtype)


@pytest.mark.parametrize("name,jax_cls,dp,convert", [
    ("ParallelWaveGANDiscriminator", JaxDisc, DP,
     weights.jax_pwg_discriminator_to_state_dict),
    ("ResidualParallelWaveGANDiscriminator", JaxResDisc, RDP,
     weights.jax_residual_pwg_discriminator_to_state_dict)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_discriminators_match_jax(name, jax_cls, dp, convert, dtype):
    disc = jax_cls(**dp)
    x = np.random.default_rng(1).standard_normal((2, 200, 1)) * 0.3
    params = _init(disc, x)
    port = build_model(name, dp)
    port.load_state_dict(convert(params, dp))
    _compare(disc, params, port, [x], dtype)


@pytest.mark.parametrize("aux", [True, False])
def test_wavenet_block_matches_jax(aux):
    block = JaxBlock(kernel_size=3, residual_channels=8, gate_channels=16,
                     skip_channels=8, aux_channels=5 if aux else -1,
                     dilation=2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 30, 8))
    c = rng.standard_normal((2, 30, 5)) if aux else None

    def apply(variables, x, c):
        return block.apply(variables, x, c)

    params = jax.device_get(jax.jit(lambda k, x, c: block.init(k, x, c))(
        jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32),
        None if c is None else jnp.asarray(c, jnp.float32))["params"])
    port = WaveNetResidualBlock(3, 8, 16, 8, 5 if aux else -1, dilation=2)
    sd = {}
    for name in params:
        weights._conv1d(sd, name, params[name])
    port.load_state_dict(sd)
    for dtype, tol in TOL.items():
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        with jax.enable_x64(dtype == torch.float64):
            p = jax.tree.map(lambda a: jnp.asarray(a, np_dtype), params)
            want = jax.jit(apply)({"params": p}, jnp.asarray(x, np_dtype),
                                  None if c is None
                                  else jnp.asarray(c, np_dtype))
        with torch.no_grad():
            got = port.to(dtype)(torch.tensor(x, dtype=dtype),
                                 None if c is None
                                 else torch.tensor(c, dtype=dtype))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def _upsample_sd(params, n, stride, prefix=""):
    """JAX UpsampleNetwork weights (effective) -> weight-normed keys."""
    sd = {}
    for i in range(n):
        w = np.transpose(params[f"conv_{i}_w"], (3, 2, 0, 1))
        key = f"{prefix}up_layers.{1 + i * stride}"
        sd[f"{key}.weight_v"] = torch.tensor(w)
        sd[f"{key}.weight_g"] = torch.tensor(
            np.sqrt((w ** 2).sum(axis=(1, 2, 3), keepdims=True)))
    return sd


@pytest.mark.parametrize("act", [None, "LeakyReLU"])
def test_upsample_networks_match_jax(act):
    kwargs = dict(upsample_scales=(3, 2), freq_axis_kernel_size=3,
                  nonlinear_activation=act)
    c = np.random.default_rng(3).standard_normal((2, 7, 5))
    net = JaxUpsample(**kwargs)
    params = _init(net, c)
    stride = 2 if act is None else 3
    for dtype in TOL:
        port = _load(UpsampleNetwork(**kwargs),
                     _upsample_sd(_cast(params, dtype), 2, stride), dtype)
        _compare(net, params, port, [c], dtype)
    # with the context conv in front
    conv_in = JaxConvIn(aux_channels=5, aux_context_window=1,
                        use_weight_norm=True, **kwargs)
    params = _init(conv_in, c)
    for dtype in TOL:
        cast = _cast(params, dtype)
        sd = _upsample_sd(cast["upsample"], 2, stride, "upsample.")
        weights._conv1d(sd, "conv_in", cast["conv_in"])
        port = _load(ConvInUpsampleNetwork(aux_channels=5,
                                           aux_context_window=1,
                                           use_weight_norm=True, **kwargs),
                     sd, dtype)
        _compare(conv_in, params, port, [c], dtype)


def test_legacy_collater_matches_jax():
    rng = np.random.default_rng(4)
    items = [(rng.standard_normal(4000 + 400 * i).astype(np.float32),
              rng.standard_normal(((4000 + 400 * i) // 80, 13)
                                  ).astype(np.float32)) for i in range(3)]
    for noise in (True, False):
        want = JaxCollater(800, 80, 2, noise, rng=np.random.default_rng(5))(
            items)
        got = Collater(800, 80, 2, noise, rng=np.random.default_rng(5))(items)
        assert len(got["x"]) == len(want["x"]) == (2 if noise else 1)
        for g, w in zip(got["x"] + (got["y"],), want["x"] + (want["y"],)):
            np.testing.assert_array_equal(g, w)
