"""The port's ``PastSeqEncoder`` (``layers/past_encoder.py``) against the
JAX package's, on the same weights and inputs.

A narrow encoder (output 16, 8 heads, feed-forward 32, 2 layers; a past of
130 samples, so distances past the relative window of 100 take the -1e8
mask) is initialised in JAX and carried across by
``jax_params_to_state_dict`` (its ``res0`` and ``layer{i}`` trees and the
``res0`` BatchNorm statistics). In evaluation mode the outputs agree in
float64 under ``jax.enable_x64`` to 1e-8 and in float32 to 1e-5 of max
|y|; in training with dropout 0 (batch statistics) in float64 to 1e-8.
With dropout, the port's masks come from the generator handed in.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.layers.past_encoder import PastSeqEncoder as JaxEncoder
from articulatory_tpu_torch.layers.past_encoder import PastSeqEncoder
from articulatory_tpu_torch.utils import weights

torch.set_num_threads(1)

KW = dict(output_dim=16, elayers=2, ffdim=32)
B, P = 2, 130


@functools.cache
def _variables(dropout: float):
    model = JaxEncoder(dropout=dropout, **KW)
    x = np.random.default_rng(0).standard_normal((B, P, 1))
    variables = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32)))
    # running statistics away from their (0, 1) start
    rng = np.random.default_rng(1)
    stats = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        variables["batch_stats"])
    return model, variables["params"], {"batch_stats": stats}, x


def _port(params, mutables, dtype, dropout: float = 0.2):
    port = PastSeqEncoder(dropout=dropout, **KW).to(dtype)
    port.load_state_dict(weights.jax_params_to_state_dict(
        params, mutables=mutables))
    return port


def _jax_forward(model, params, mutables, x, dtype, train):
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    with jax.enable_x64(dtype == torch.float64):
        cast = functools.partial(jax.tree.map,
                                 lambda a: jnp.asarray(a, np_dtype))
        out = jax.jit(lambda v, x: model.apply(
            v, x, train=train, mutable=["batch_stats"] if train else False))(
                {"params": cast(params), **cast(mutables)},
                jnp.asarray(x, np_dtype))
        return np.asarray(out[0] if train else out)


def test_converter_covers_every_key():
    _, params, mutables, _ = _variables(0.2)
    sd = weights.jax_params_to_state_dict(params, mutables=mutables, steps=3)
    port = PastSeqEncoder(**KW).state_dict()
    assert sorted(sd) == sorted(port)
    assert all(sd[k].shape == port[k].shape for k in sd)
    assert int(sd["res0.bn1.num_batches_tracked"]) == 3


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-8),
                                       (torch.float32, 1e-5)])
def test_past_seq_encoder_matches_jax(dtype, tol):
    model, params, mutables, x = _variables(0.2)
    want = _jax_forward(model, params, mutables, x, dtype, train=False)
    port = _port(params, mutables, dtype).eval()
    with torch.no_grad():
        got = port(torch.tensor(x, dtype=dtype)).numpy()
    assert got.shape == want.shape == (B, P, KW["output_dim"])
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale


def test_past_seq_encoder_batch_statistics_match_jax():
    model, params, mutables, x = _variables(0.0)
    want = _jax_forward(model, params, mutables, x, torch.float64,
                        train=True)
    port = _port(params, mutables, torch.float64, dropout=0.0).train()
    with torch.no_grad():
        got = port(torch.tensor(x, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)


def test_dropout_draws_from_the_generator():
    _, params, mutables, x = _variables(0.2)
    port = _port(params, mutables, torch.float32).train()
    x = torch.tensor(x, dtype=torch.float32)

    def run(seed):
        with torch.no_grad():
            return port(x, torch.Generator().manual_seed(seed))

    torch.manual_seed(0)
    first = run(5)
    torch.manual_seed(1)  # the global generator plays no part
    assert torch.equal(first, run(5))
    assert not torch.equal(first, run(6))
    with torch.no_grad():
        kept = port.eval()(x)
    assert torch.equal(kept, port(x, torch.Generator().manual_seed(6)))
