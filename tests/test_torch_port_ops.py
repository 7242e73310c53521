"""articulatory_tpu_torch.ops.conv and layers.activations against the JAX
package's ops on the same numpy inputs (f32, CPU).

Tolerance rtol/atol 1e-5: both sides compute the same f32 sums in different
orders (XLA's CPU conv vs oneDNN), a few ulps at these sizes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from articulatory_tpu.layers.activations import get_activation as jax_activation
from articulatory_tpu.ops import conv as jax_conv
from articulatory_tpu_torch.layers.activations import get_activation
from articulatory_tpu_torch.ops import conv

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,c_in,c_out,k,stride,padding,dilation,groups", [
    (37, 5, 7, 3, 1, 1, 1, 1),          # ragged length, narrow C_in
    (50, 8, 16, 7, 1, 9, 3, 1),         # dilated SAME
    (41, 8, 12, 5, 2, 2, 1, 1),         # strided
    (64, 16, 8, 41, 4, 20, 1, 4),       # grouped (densified on the TPU)
    (33, 6, 6, 4, 1, (2, 1), 1, 1),     # explicit (lo, hi) padding
    (29, 3, 5, 3, 3, (0, 4), 2, 1),     # asymmetric, strided, dilated
])
def test_conv1d_matches_jax(t, c_in, c_out, k, stride, padding, dilation,
                            groups):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, c_in)).astype(np.float32)
    w = rng.standard_normal((k, c_in // groups, c_out)).astype(np.float32)
    b = rng.standard_normal((c_out,)).astype(np.float32)
    ref = jax_conv.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          stride=stride, padding=padding, dilation=dilation,
                          groups=groups)
    out = conv.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), stride=stride, padding=padding,
                      dilation=dilation, groups=groups)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    if isinstance(padding, int):
        assert out.shape[1] == conv.conv1d_output_length(
            t, k, stride, padding, dilation)


@pytest.mark.parametrize("t,k,stride,padding,output_padding,dilation", [
    (10, 10, 5, 3, 1, 1),   # the e2w generator's first upsampler
    (13, 8, 4, 2, 0, 1),
    (7, 4, 2, 1, 0, 1),
    (9, 5, 3, 2, 1, 2),     # dilated, output_padding
])
def test_conv_transpose1d_matches_jax(t, k, stride, padding, output_padding,
                                      dilation):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, t, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6, 4)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    ref = jax_conv.conv_transpose1d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
        padding=padding, output_padding=output_padding, dilation=dilation)
    out = conv.conv_transpose1d(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        stride=stride, padding=padding, output_padding=output_padding,
        dilation=dilation)
    assert out.shape == ref.shape
    assert out.shape[1] == conv.conv_transpose1d_output_length(
        t, k, stride, padding, output_padding, dilation)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name,params", [
    ("LeakyReLU", {"negative_slope": 0.1}), ("LeakyReLU", None), ("ReLU", None),
    ("Tanh", None), ("GELU", None), ("ELU", {"alpha": 0.5}), ("SELU", None),
    ("Softplus", {"beta": 2.0, "threshold": 5.0}), ("Sigmoid", None),
])
def test_activations_match_jax(name, params):
    x = np.linspace(-8, 8, 161, dtype=np.float32)
    ref = jax_activation(name, params)(jnp.asarray(x))
    out = get_activation(name, params)(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_leaky_relu_matches_jax():
    x = np.linspace(-3, 3, 61, dtype=np.float32)
    np.testing.assert_array_equal(
        conv.leaky_relu(torch.from_numpy(x), 0.01).numpy(),
        np.asarray(jax_conv.leaky_relu(jnp.asarray(x), 0.01)))
