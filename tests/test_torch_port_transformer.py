"""The port's Transformer (``models/transformer.py``,
``layers/transformer.py``, the conv-BatchNorm ``ResBlock``) against the JAX
package's, on the same weights and inputs.

A narrow model (hidden 16, 8 heads, 2 layers; 130 frames, so distances
past the relative window of 100 take the -1e8 mask) is initialised in JAX
and carried across by ``jax_transformer_to_state_dict``, held key for key
and array for array against ``export_transformer``. Outputs agree in
float64 under ``jax.enable_x64`` to 1e-8 and in float32 to rtol 1e-4 /
atol 1e-5, in evaluation mode (running statistics) and in training with
dropout 0 (batch statistics), where the updated BatchNorm running
statistics are held against JAX's ``batch_stats`` too."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.layers.residual import ResBlock as JaxResBlock
from articulatory_tpu.layers.transformer import (
    MultiHeadAttention as JaxMHA,
    TransformerEncoderLayer as JaxLayer,
    _relative_position_logits,
)
from articulatory_tpu.models.transformer import Transformer as JaxTransformer
from articulatory_tpu.utils.torch_export import export_transformer
from articulatory_tpu_torch.layers.residual import ResBlock
from articulatory_tpu_torch.layers.transformer import (
    MultiHeadAttention,
    TransformerEncoderLayer,
    relative_position_logits,
)
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.utils import weights

torch.set_num_threads(1)

GP = dict(in_channels=13, out_channels=12, elayers=2, hidden_dim=16,
          dropout=0.0)
TOL = {torch.float64: dict(rtol=1e-8, atol=1e-8),
       torch.float32: dict(rtol=1e-4, atol=1e-5)}


def _np_dtype(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


@functools.cache
def _model():
    model = JaxTransformer(**GP)
    x = np.random.default_rng(0).standard_normal((2, 130, 13))
    variables = jax.device_get(jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x, jnp.float32)))
    # running statistics away from their (0, 1) start
    rng = np.random.default_rng(1)
    stats = jax.tree.map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.ndim else a
                   ).astype(np.float32), variables["batch_stats"])
    return model, variables["params"], {"batch_stats": stats}, x


def _port(params, mutables, dtype):
    port = build_model("Transformer", GP).to(dtype)
    port.load_state_dict(weights.jax_transformer_to_state_dict(
        params, mutables, GP))
    return port


def test_converter_matches_exporter():
    _, params, mutables, _ = _model()
    ours = weights.jax_transformer_to_state_dict(params, mutables, GP,
                                                 steps=7)
    theirs = export_transformer(params, mutables, GP, steps=7)
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_transformer_matches_jax(train, dtype):
    model, params, mutables, x = _model()
    np_dtype = _np_dtype(dtype)
    with jax.enable_x64(dtype == torch.float64):
        cast = functools.partial(jax.tree.map,
                                 lambda a: jnp.asarray(a, np_dtype))
        variables = {"params": cast(params), **cast(mutables)}
        fwd = jax.jit(lambda v, x: model.apply(
            v, x, train=train, mutable=["batch_stats"] if train else False,
            rngs={"dropout": jax.random.PRNGKey(2)}))
        out = fwd(variables, jnp.asarray(x, np_dtype))
        want, new_stats = (out if train else (out, None))
        want = np.asarray(want)
    port = _port(params, mutables, dtype).train(train)
    with torch.no_grad():
        got = port(torch.tensor(x, dtype=dtype))
    assert got.shape == want.shape == (2, 130, 12)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    if train:
        updated = weights.jax_transformer_to_state_dict(
            params, jax.device_get(new_stats), GP, steps=1)
        for key, value in port.state_dict().items():
            if "running" in key or "num_batches" in key:
                np.testing.assert_allclose(value.numpy(),
                                           updated[key].numpy(),
                                           **TOL[dtype], err_msg=key)


def test_relative_position_logits_match_jax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 3, 12, 4))
    table = rng.standard_normal((3, 9, 4))
    with jax.enable_x64(True):
        want = np.asarray(_relative_position_logits(jnp.asarray(q),
                                                    jnp.asarray(table), 5))
    got = relative_position_logits(torch.tensor(q), torch.tensor(table), 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    assert (got.numpy() < -1e7).sum() == 2 * 3 * (12 - 5) * (12 - 4)


def _attention_sd(p, prefix=""):
    sd = {f"{prefix}{k}": torch.tensor(np.asarray(p[k]))
          for k in ("w_q", "w_k", "w_v", "w_o")}
    sd[f"{prefix}relative_positional.embeddings"] = torch.tensor(
        np.asarray(p["rel_embeddings"])[..., None])
    return sd


@pytest.mark.parametrize("layer", [False, True])
def test_attention_and_layer_match_jax(layer):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 14, 16))
    kwargs = dict(relative_positional=True, relative_positional_distance=4)
    if layer:
        jax_mod = JaxLayer(d_model=16, nhead=4, dim_feedforward=24,
                           dropout=0.0, **kwargs)
        port = TransformerEncoderLayer(16, 4, 24, 0.0, **kwargs)
    else:
        jax_mod = JaxMHA(d_model=16, n_head=4, dropout=0.0, **kwargs)
        port = MultiHeadAttention(16, 4, 0.0, **kwargs)
    params = jax.device_get(jax.jit(jax_mod.init)(
        jax.random.PRNGKey(3), jnp.asarray(x, jnp.float32))["params"])
    if layer:
        sd = _attention_sd(params["self_attn"], "self_attn.")
        for name in ("linear1", "linear2"):
            weights._linear(sd, name, params[name])
        for name in ("norm1", "norm2"):
            sd[f"{name}.weight"] = torch.tensor(params[name]["scale"])
            sd[f"{name}.bias"] = torch.tensor(params[name]["bias"])
    else:
        sd = _attention_sd(params)
    port.load_state_dict(sd)
    for dtype, tol in TOL.items():
        np_dtype = _np_dtype(dtype)
        with jax.enable_x64(dtype == torch.float64):
            p = jax.tree.map(lambda a: jnp.asarray(a, np_dtype), params)
            want = np.asarray(jax.jit(jax_mod.apply)(
                {"params": p}, jnp.asarray(x, np_dtype)))
        with torch.no_grad():
            got = port.to(dtype).eval()(torch.tensor(x, dtype=dtype))
        np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("features", [5, 8])
def test_resblock_matches_jax(features):
    block = JaxResBlock(features=8)
    x = np.random.default_rng(4).standard_normal((3, 10, features))
    variables = jax.device_get(jax.jit(block.init)(
        jax.random.PRNGKey(4), jnp.asarray(x, jnp.float32)))
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for name in ("conv1", "conv2", "residual_path"):
        if name in params:
            weights._conv1d(sd, name, params[name])
    for name in ("bn1", "bn2", "res_norm"):
        if name in params:
            weights._batch_norm(sd, name, params[name], stats[name])
    port = ResBlock(features, 8)
    port.load_state_dict(sd)
    with jax.enable_x64(True):
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        want, new = jax.jit(lambda v, x: block.apply(
            v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    port.double().train()
    with torch.no_grad():
        got = port(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[
        torch.float64])
    for name, s in new["batch_stats"].items():
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(getattr(port, name), ours).numpy(),
                np.asarray(s[theirs]), rtol=1e-10, atol=1e-12)
