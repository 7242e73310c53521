"""The port's PQMF (``ops/pqmf.py``) and multi-band HiFi-GAN synthesis
(``inference.load_model`` / ``LoadedModel.inference``) against the JAX
package's.

The prototype and the filterbanks are held equal to JAX's. Analysis and
synthesis at 2, 4 and 8 bands, on lengths divisible by the band count and
not, agree in float64 to 1e-12 (the JAX package keeps its filters float32,
which its float64 convs refuse, so the test hands it the same values in
float64) and in float32 to rtol 1e-4 / atol 1e-5. A narrow 4-band
generator (``out_channels: 4``, ``pqmf: true``) loaded from a JAX msgpack
checkpoint synthesises what JAX's generator and PQMF give, in float32 to
atol 1e-5; a 4-channel model without ``pqmf`` is left unsynthesised."""

import functools

import flax.serialization
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.models.hifigan import HiFiGANGenerator as JaxGenerator
from articulatory_tpu.ops import pqmf as jax_pqmf
from articulatory_tpu_torch.inference import load_model
from articulatory_tpu_torch.ops import pqmf

torch.set_num_threads(1)

BANDS = [(2, 62, 0.267, 9.0), (4, 62, 0.142, 9.0), (8, 62, 0.07949, 9.0)]
GP = dict(in_channels=13, out_channels=4, channels=16, kernel_size=7,
          upsample_scales=[5, 2, 2], upsample_kernel_sizes=[10, 4, 4],
          resblock_kernel_sizes=[3, 7], resblock_dilations=[[1, 3], [1, 3]],
          use_ar=False)


def test_filters_match_jax():
    for args in BANDS:
        np.testing.assert_array_equal(
            pqmf.design_prototype_filter(*args[1:]),
            jax_pqmf.design_prototype_filter(*args[1:]))
        for ours, theirs in zip(pqmf.pqmf_filterbanks(*args),
                                jax_pqmf.pqmf_filterbanks(*args)):
            np.testing.assert_array_equal(ours, theirs)
    with pytest.raises(ValueError, match="even"):
        pqmf.design_prototype_filter(61)


def _jax_pqmf(args, dtype):
    bank = jax_pqmf.PQMF(*args)
    if dtype == torch.float64:
        bank.analysis_filter = bank.analysis_filter.astype(jnp.float64)
        bank.synthesis_filter = bank.synthesis_filter.astype(jnp.float64)
    return bank


@pytest.mark.parametrize("args", BANDS)
@pytest.mark.parametrize("length", [800, 803])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_analysis_and_synthesis_match_jax(args, length, dtype):
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    tol = (dict(rtol=1e-12, atol=1e-12) if dtype == torch.float64
           else dict(rtol=1e-4, atol=1e-5))
    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, length, 1)).astype(np_dtype)
    bands = rng.standard_normal((2, length // args[0], args[0])
                                ).astype(np_dtype)
    port = pqmf.PQMF(*args)
    with jax.enable_x64(dtype == torch.float64):
        bank = _jax_pqmf(args, dtype)
        want_a = np.asarray(bank.analysis(jnp.asarray(x)))
        want_s = np.asarray(bank.synthesis(jnp.asarray(bands)))
    got_a = port.analysis(torch.tensor(x)).numpy()
    got_s = port.synthesis(torch.tensor(bands)).numpy()
    assert got_a.shape == want_a.shape == (2, length // args[0], args[0])
    assert got_s.shape == want_s.shape == (2, length // args[0] * args[0], 1)
    np.testing.assert_allclose(got_a, want_a, **tol)
    np.testing.assert_allclose(got_s, want_s, **tol)


@functools.cache
def _jax_generator():
    model = JaxGenerator(**{k: tuple(map(tuple, v)) if k == "resblock_dilations"
                            else tuple(v) if isinstance(v, list) else v
                            for k, v in GP.items()})
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 10, 13)))["params"]
    return model, jax.device_get(params)


@pytest.mark.parametrize("multiband", [True, False])
def test_multiband_generator_synthesises_like_jax(tmp_path, multiband):
    model, params = _jax_generator()
    path = tmp_path / "ckpt.pkl"
    path.write_bytes(flax.serialization.msgpack_serialize(
        {"model": {"generator": params}, "steps": 1}))
    config = {"generator_type": "HiFiGANGenerator", "generator_params": GP,
              "pqmf": multiband, "sampling_rate": 16000, "hop_size": 80}
    c = np.random.default_rng(1).standard_normal((25, 13)).astype(np.float32)
    loaded = load_model(str(path), config, device="cpu")
    got = loaded.inference(c, bucket_frames=8)
    bands = model.apply({"params": params}, jnp.asarray(c[None]))
    if multiband:
        want = np.asarray(jax_pqmf.PQMF(4).synthesis(bands))[0]
        assert got.shape == (25 * 80, 1)
    else:
        want = np.asarray(bands)[0]
        assert got.shape == (25 * 20, 4)
    # bucket padding reaches only the last receptive field
    np.testing.assert_allclose(got[:-400], want[:-400], rtol=1e-4,
                               atol=1e-5)
