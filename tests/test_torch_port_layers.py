"""The port's layers against the JAX package's on the same weights (f32, CPU,
rtol/atol 1e-5: the same sums in a different order).

The weights cross over through the JAX package's own exporter
(``utils/torch_export._Flat``), so these tests also pin that the port's
parameter names and layouts (weight-norm axes included) are the reference's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.layers import conv as jax_layers
from articulatory_tpu.layers.past_encoder import PastFCEncoder as JaxPastFC
from articulatory_tpu.utils.torch_export import _Flat
from articulatory_tpu_torch.layers.conv import Conv1d, ConvTranspose1d, Dense
from articulatory_tpu_torch.layers.past_encoder import PastFCEncoder

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _load(module, export, prefix, params):
    flat = _Flat()
    getattr(flat, export)(prefix, params)
    module.load_state_dict({k[len(prefix) + 1:]: torch.tensor(v)
                            for k, v in flat.sd.items()})


@pytest.mark.parametrize("use_weight_norm", [True, False])
@pytest.mark.parametrize("dilation,groups", [(1, 1), (3, 2)])
def test_conv1d_layer_matches_jax(use_weight_norm, dilation, groups):
    rng = np.random.default_rng(dilation)
    x = rng.standard_normal((2, 31, 8)).astype(np.float32)
    jl = jax_layers.Conv1d(6, 5, dilation=dilation, groups=groups,
                           padding=2 * dilation,
                           use_weight_norm=use_weight_norm)
    params = jax.device_get(jl.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    layer = Conv1d(8, 6, 5, dilation=dilation, groups=groups,
                   padding=2 * dilation, use_weight_norm=use_weight_norm)
    _load(layer, "conv1d", "m", params["params"])
    ref = np.asarray(jl.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(), ref,
                                   **TOL)


@pytest.mark.parametrize("use_weight_norm", [True, False])
def test_conv_transpose1d_layer_matches_jax(use_weight_norm):
    # weight norm here is per INPUT channel (torch dim 0 of (C_in, C_out, K))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 8)).astype(np.float32)
    jl = jax_layers.ConvTranspose1d(4, 10, stride=5, padding=3,
                                    output_padding=1,
                                    use_weight_norm=use_weight_norm)
    params = jax.device_get(jl.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    layer = ConvTranspose1d(8, 4, 10, stride=5, padding=3, output_padding=1,
                            use_weight_norm=use_weight_norm)
    _load(layer, "conv_transpose1d", "m", params["params"])
    ref = np.asarray(jl.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(), ref,
                                   **TOL)


def test_dense_matches_jax():
    x = np.random.default_rng(4).standard_normal((3, 7)).astype(np.float32)
    jl = jax_layers.Dense(5)
    params = jax.device_get(jl.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    layer = Dense(7, 5)
    _load(layer, "linear", "m", params["params"])
    with torch.no_grad():
        np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(),
                                   np.asarray(jl.apply(params, jnp.asarray(x))),
                                   **TOL)


@pytest.mark.parametrize("past_len,channels", [(64, 1), (16, 4)])
def test_past_fc_encoder_matches_jax(past_len, channels):
    """(B, P, C) past samples, flattened channel-major: with C > 1 a
    time-major flatten would give other numbers."""
    rng = np.random.default_rng(past_len)
    ar = rng.standard_normal((3, past_len, channels)).astype(np.float32)
    jm = JaxPastFC(input_len=past_len * channels, hidden_dim=8, output_dim=6)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(ar)))
    flat = _Flat()
    for li, ti in enumerate([0, 2, 4, 6, 8]):
        flat.linear(f"model.{ti}", params["params"][f"fc{li}"])
    enc = PastFCEncoder(past_len * channels, 8, 6)
    enc.load_state_dict({k: torch.tensor(v) for k, v in flat.sd.items()})
    with torch.no_grad():
        out = enc(torch.from_numpy(ar)).numpy()
    np.testing.assert_allclose(out, np.asarray(jm.apply(params, jnp.asarray(ar))),
                               **TOL)


def test_torch_default_init_bounds():
    """Torch's default init: U(+-1/sqrt(fan_in)), fan_in = C_in*K for a conv
    and C_out*K for a transposed conv; weight norm starts at g = ||v||."""
    gen = torch.Generator().manual_seed(0)
    conv = Conv1d(16, 8, 5, use_weight_norm=True, generator=gen)
    assert conv.weight_v.abs().max() <= 1 / np.sqrt(16 * 5)
    torch.testing.assert_close(conv.torch_weight(), conv.weight_v)
    convt = ConvTranspose1d(16, 4, 8, stride=4, generator=gen)
    assert convt.weight.abs().max() <= 1 / np.sqrt(4 * 8)
    assert convt.weight.abs().max() > 0.5 / np.sqrt(4 * 8)
