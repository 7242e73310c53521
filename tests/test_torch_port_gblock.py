"""The port's GBlock generator (``models/gblock_gen.py``, ``GBlock``) against
the JAX package's, on the same weights and inputs.

A narrow generator (channels 16, scales (2, 1, 2) with odd kernels; with
and without the AR encoder) is initialised in JAX and carried across by
``jax_gblock_generator_to_state_dict``, held key for key and array for
array against ``export_gblock_generator``. Outputs agree in float64 under
``jax.enable_x64`` to 1e-8 and in float32 to rtol 1e-4 / atol 1e-5."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.layers.residual import GBlock as JaxGBlock
from articulatory_tpu.models.gblock_gen import GBlockGenerator as JaxGen
from articulatory_tpu.utils.torch_export import export_gblock_generator
from articulatory_tpu_torch.layers.residual import GBlock
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.utils import weights

torch.set_num_threads(1)

GP = dict(in_channels=13, out_channels=1, channels=16, kernel_size=7,
          g_scales=[2, 1, 2], g_kernel_sizes=[5, 3, 5])
AR_GP = dict(GP, in_channels=13 + 8, use_ar=True, ar_input=32, ar_hidden=8,
             ar_output=8)
TOL = {torch.float64: dict(rtol=1e-8, atol=1e-8),
       torch.float32: dict(rtol=1e-4, atol=1e-5)}


def _jax_kwargs(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


@functools.cache
def _generator(use_ar):
    gp = AR_GP if use_ar else GP
    gen = JaxGen(**_jax_kwargs(gp))
    rng = np.random.default_rng(0)
    c = rng.standard_normal((2, 12, 13))
    ar = rng.standard_normal((2, 32, 1)) * 0.3 if use_ar else None
    kwargs = {} if ar is None else {"ar": jnp.asarray(ar, jnp.float32)}
    params = jax.device_get(jax.jit(gen.init)(
        jax.random.PRNGKey(0), jnp.asarray(c, jnp.float32),
        **kwargs)["params"])
    return gp, gen, params, c, ar


@pytest.mark.parametrize("use_ar", [False, True])
def test_converter_matches_exporter(use_ar):
    gp, _, params, _, _ = _generator(use_ar)
    ours = weights.jax_gblock_generator_to_state_dict(params, gp)
    theirs = export_gblock_generator(params, gp)
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("use_ar", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_generator_matches_jax(use_ar, dtype):
    gp, gen, params, c, ar = _generator(use_ar)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    with jax.enable_x64(dtype == torch.float64):
        p = jax.tree.map(lambda a: jnp.asarray(a, np_dtype), params)
        kwargs = {} if ar is None else {"ar": jnp.asarray(ar, np_dtype)}
        want = np.asarray(jax.jit(gen.apply)({"params": p},
                                             jnp.asarray(c, np_dtype),
                                             **kwargs))
    port = build_model("GBlockGenerator", gp).to(dtype)
    port.load_state_dict(weights.jax_gblock_generator_to_state_dict(params,
                                                                    gp))
    with torch.no_grad():
        got = port(torch.tensor(c, dtype=dtype),
                   None if ar is None else torch.tensor(ar, dtype=dtype))
    assert got.shape == want.shape == (2, 12 * 4, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("upsample", [1, 3])
def test_gblock_matches_jax(upsample):
    block = JaxGBlock(output_dim=6, upsample=upsample, kernel_size=3)
    x = np.random.default_rng(1).standard_normal((2, 9, 4))
    params = jax.device_get(jax.jit(block.init)(
        jax.random.PRNGKey(1), jnp.asarray(x, jnp.float32))["params"])
    off = 1 if upsample > 1 else 0
    sd = {}
    for name, key in (("conv1_a", f"conv1.{1 + off}"),
                      ("conv1_b", f"conv1.{3 + off}"),
                      ("res1", f"res1.{off}"), ("conv2_a", "conv2.1"),
                      ("conv2_b", "conv2.3")):
        weights._conv1d(sd, key, params[name])
    port = GBlock(4, 6, upsample, 3)
    port.load_state_dict(sd)
    for dtype, tol in TOL.items():
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        with jax.enable_x64(dtype == torch.float64):
            p = jax.tree.map(lambda a: jnp.asarray(a, np_dtype), params)
            want = np.asarray(jax.jit(block.apply)({"params": p},
                                                   jnp.asarray(x, np_dtype)))
        with torch.no_grad():
            got = port.to(dtype)(torch.tensor(x, dtype=dtype))
        assert got.shape == want.shape == (2, 9 * upsample, 6)
        np.testing.assert_allclose(got.numpy(), want, **tol)


def test_even_kernels_raise():
    with pytest.raises(ValueError, match="odd"):
        build_model("GBlockGenerator", dict(GP, g_kernel_sizes=[4, 3, 5]))
