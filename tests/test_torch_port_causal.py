"""Causal convs (``use_causal_conv``) of the port against the JAX package:
``CausalConv1d`` and ``CausalConvTranspose1d`` (``layers/conv.py``), the
causal MelGAN and Parallel WaveGAN generators and the residual PWG
discriminator on the same weights and inputs, carried across by the port's
converters (``utils/weights.py``), and one causal MelGAN training step.

The JAX package's importer refuses causal MelGAN and its exporter writes
the non-causal layout only, so the converters are held by the forward:
the port's state dict must load strictly (the reference's causal keys,
``melgan.0.conv``, ``melgan.{i}.deconv``, ``stack.1.conv``) and compute
JAX's outputs. Forwards agree in float64 under ``jax.enable_x64`` to 1e-8
and in float32 to rtol 1e-4 / atol 1e-5; the step's losses and each
model's gradient (relative L2 pooled over its tensors) to 1e-8 in float64,
through ``tests/test_torch_port_zoo_train.py``'s comparison. Causality is
checked on the port: a change to the input after frame t leaves the output
up to frame t as it was."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_port_zoo_train as zoo
from articulatory_tpu import models as jax_models
from articulatory_tpu.layers.conv import (
    CausalConv1d as JaxCausalConv1d,
    CausalConvTranspose1d as JaxCausalConvTranspose1d,
)
from articulatory_tpu_torch.layers.conv import (
    CausalConv1d,
    CausalConvTranspose1d,
)
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.utils import weights

torch.set_num_threads(1)
# JAX's programs compiled at XLA's lowest backend optimisation level, as
# in tests/test_torch_port_cond_train.py
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_llvm_disable_expensive_passes": True})

TOL = {torch.float64: dict(rtol=1e-8, atol=1e-8),
       torch.float32: dict(rtol=1e-4, atol=1e-5)}

MELGAN = dict(in_channels=13, out_channels=1, kernel_size=7, channels=32,
              upsample_scales=[4, 2], stacks=2, use_causal_conv=True)
PWG = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
           skip_channels=8, aux_channels=13, aux_context_window=2,
           upsample_params={"upsample_scales": [4, 2]}, use_causal_conv=True)
# (JAX class, params, converter, the inputs' shapes, frames -> samples)
MODELS = {
    "melgan": ("MelGANGenerator", MELGAN,
               weights.jax_melgan_generator_to_state_dict, [(2, 12, 13)], 8),
    # an even stack kernel: causal stacks take any width
    "melgan_even": ("MelGANGenerator", dict(MELGAN, stack_kernel_size=2),
                    weights.jax_melgan_generator_to_state_dict,
                    [(2, 12, 13)], 8),
    "pwg": ("ParallelWaveGANGenerator", PWG,
            weights.jax_pwg_generator_to_state_dict,
            [(2, 96, 1), (2, 16, 13)], 8),
    "pwg_upsample_net": (
        "ParallelWaveGANGenerator",
        dict(PWG, upsample_net="UpsampleNetwork", aux_context_window=0,
             upsample_params={"upsample_scales": [4, 2],
                              "freq_axis_kernel_size": 3}),
        weights.jax_pwg_generator_to_state_dict,
        [(2, 96, 1), (2, 12, 13)], 8),
    "residual_pwg_disc": (
        "ResidualParallelWaveGANDiscriminator",
        dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
             skip_channels=8, use_causal_conv=True),
        weights.jax_residual_pwg_discriminator_to_state_dict,
        [(2, 96, 1)], 1),
}


def _np(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _tuples(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


@functools.cache
def _inputs(name):
    rng = np.random.default_rng(len(name))
    return [rng.standard_normal(s) for s in MODELS[name][3]]


@functools.cache
def _jax_params(name):
    cls, params, *_ = MODELS[name]
    module = jax_models.build_model(cls, params)
    x = [jnp.asarray(a, jnp.float32) for a in _inputs(name)]
    v = _jit(module.init)(jax.random.PRNGKey(3), *x)
    return module, jax.device_get(v["params"])


def _jax_apply(module, params, inputs, dtype):
    np_dtype = _np(dtype)
    with jax.enable_x64(dtype == torch.float64):
        p = jax.tree.map(lambda a: jnp.asarray(a, np_dtype), params)
        out = _jit(module.apply)({"params": p},
                                 *[jnp.asarray(a, np_dtype) for a in inputs])
        return np.asarray(out)


def _port(name, params, dtype):
    cls, gp, convert, *_ = MODELS[name]
    model = build_model(cls, gp).to(dtype)
    cast = jax.tree.map(lambda a: np.asarray(a, _np(dtype)), params)
    model.load_state_dict(convert(cast, gp))  # strict: the causal keys
    return model.eval()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layer", ["conv", "conv_wn_pad", "deconv",
                                   "deconv_wn"])
def test_causal_layers_match_jax(layer, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 6))
    wn = layer.endswith(("_wn", "_wn_pad"))
    if layer.startswith("conv"):
        pad_value = 0.5 if layer.endswith("_pad") else 0.0
        jmod = JaxCausalConv1d(5, 3, dilation=2, use_weight_norm=wn,
                               pad_value=pad_value)
        port = CausalConv1d(6, 5, 3, dilation=2, use_weight_norm=wn,
                            pad_value=pad_value)
    else:
        jmod = JaxCausalConvTranspose1d(5, 6, stride=3, use_weight_norm=wn)
        port = CausalConvTranspose1d(6, 5, 6, stride=3, use_weight_norm=wn)
    params = jax.device_get(_jit(jmod.init)(
        jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32))["params"])
    sd = {}
    cast = jax.tree.map(lambda a: np.asarray(a, _np(dtype)), params)
    if layer.startswith("conv"):
        weights._conv1d(sd, "conv", cast["conv"])
    else:
        weights._conv_transpose1d(sd, "deconv", cast["deconv"])
    port = port.to(dtype)
    port.load_state_dict(sd)
    want = _jax_apply(jmod, params, [x], dtype)
    with torch.no_grad():
        got = port(torch.tensor(x, dtype=dtype)).numpy()
    assert got.shape == want.shape == (
        (2, 9, 5) if layer.startswith("conv") else (2, 27, 5))
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_causal_models_match_jax(name, dtype):
    module, params = _jax_params(name)
    inputs = _inputs(name)
    want = _jax_apply(module, params, inputs, dtype)
    model = _port(name, params, dtype)
    with torch.no_grad():
        got = model(*[torch.tensor(a, dtype=dtype) for a in inputs]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL[dtype])
    if name.startswith("melgan"):
        keys = model.state_dict()
        assert "melgan.0.conv.weight_v" in keys
        assert "melgan.2.deconv.weight_v" in keys
        assert "melgan.3.stack.1.conv.weight_v" in keys


@pytest.mark.parametrize("name", ["melgan", "pwg"])
def test_causal_models_see_no_future(name):
    """Inputs past frame t move no output sample before frame t + 1."""
    _, params = _jax_params(name)
    model = _port(name, params, torch.float64)
    inputs = [torch.tensor(a) for a in _inputs(name)]
    hop = MODELS[name][4]
    cut = 6  # frames of the features kept
    changed = [a.clone() for a in inputs]
    changed[-1][:, cut:] += 1.0
    if name == "pwg":  # the noise is per sample, the features per frame
        changed[0][:, (cut - 2) * hop:] += 1.0  # 2 frames of aux context
        cut -= 2
    with torch.no_grad():
        a, b = model(*inputs), model(*changed)
    torch.testing.assert_close(a[:, : cut * hop], b[:, : cut * hop],
                               rtol=0, atol=0)
    assert not torch.equal(a, b)


zoo.FAMILIES["melgan_causal"] = dataclasses.replace(
    zoo.FAMILIES["melgan"],
    gp=dict(zoo.FAMILIES["melgan"].gp, use_causal_conv=True))


def test_causal_melgan_train_step_matches_jax():
    """One GAN step of the causal MelGAN against JAX's in float64: the
    losses and both models' gradients (1e-8), through the zoo's step
    comparison."""
    zoo.test_train_step_matches_jax("melgan_causal", torch.float64)
