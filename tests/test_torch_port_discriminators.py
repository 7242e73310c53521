"""The port's HiFi-GAN discriminators against the JAX package's.

A small ``HiFiGANMultiScaleMultiPeriodDiscriminator`` (2 scales with the
configs' 128-channel head and stride-4 layer 1, 2 periods, narrow widths)
is initialised in JAX and carried across by ``jax_msmpd_to_state_dict``;
every feature map of every sub-discriminator is held against JAX's in
float64 (1e-10) and float32 (1e-5). The carry-over is held key for key and
array for array against the JAX package's ``export_hifigan_msmpd``."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.models.hifigan import (
    HiFiGANMultiScaleMultiPeriodDiscriminator as JaxMSMPD,
)
from articulatory_tpu.utils.torch_export import export_hifigan_msmpd
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.utils.weights import jax_msmpd_to_state_dict

torch.set_num_threads(1)

DP = dict(scales=2, scale_downsample_pooling="AvgPool1d",
          scale_downsample_pooling_params=dict(kernel_size=4, stride=2,
                                               padding=2),
          scale_discriminator_params=dict(
              in_channels=1, out_channels=1, kernel_sizes=[15, 41, 5, 3],
              channels=128, max_downsample_channels=256, max_groups=16,
              bias=True, downsample_scales=[4, 4, 1],
              nonlinear_activation="LeakyReLU",
              nonlinear_activation_params=dict(negative_slope=0.1)),
          follow_official_norm=True, periods=[2, 3],
          period_discriminator_params=dict(
              in_channels=1, out_channels=1, kernel_sizes=[5, 3], channels=4,
              downsample_scales=[3, 3, 1], max_downsample_channels=16,
              bias=True, nonlinear_activation="LeakyReLU",
              nonlinear_activation_params=dict(negative_slope=0.1),
              use_weight_norm=True, use_spectral_norm=False))


def _jax_kwargs(d):
    return {k: _jax_kwargs(v) if isinstance(v, dict)
            else tuple(v) if isinstance(v, list) else v for k, v in d.items()}


@functools.cache
def _model():
    jdisc = JaxMSMPD(**_jax_kwargs(DP))
    x = np.random.default_rng(0).standard_normal((2, 301, 1)) * 0.3
    params = jax.device_get(jax.jit(jdisc.init)(
        jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32))["params"])
    return jdisc, params, x


def _port(params, dtype):
    disc = build_model("HiFiGANMultiScaleMultiPeriodDiscriminator", DP)
    disc.load_state_dict(jax_msmpd_to_state_dict(params, DP))
    return disc.to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
def test_msmpd_feature_maps_match_jax(dtype, tol):
    jdisc, params, x = _model()
    if dtype == torch.float64:
        with jax.enable_x64(True):
            p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
            want = jax.device_get(jdisc.apply({"params": p64},
                                              jnp.asarray(x, jnp.float64)))
    else:
        want = jax.device_get(jdisc.apply({"params": params},
                                          jnp.asarray(x, jnp.float32)))
    with torch.no_grad():
        got = _port(params, dtype)(torch.tensor(x, dtype=dtype))
    assert len(got) == len(want) == 4
    for g_maps, w_maps in zip(got, want):
        assert len(g_maps) == len(w_maps)
        for g, w in zip(g_maps, w_maps):
            assert g.dtype == dtype and g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                       atol=tol)


def test_msmpd_carry_over_matches_jax_exporter():
    _, params, _ = _model()
    ours = jax_msmpd_to_state_dict(params, DP)
    theirs = export_hifigan_msmpd(params, DP)
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value)
    # and it is exactly the port's module tree
    disc = build_model("HiFiGANMultiScaleMultiPeriodDiscriminator", DP)
    assert sorted(disc.state_dict()) == sorted(ours)


def test_scale_discriminator_uses_the_head_only_in_its_shape():
    disc = build_model("HiFiGANMultiScaleMultiPeriodDiscriminator", DP)
    assert all(d.use_head for d in disc.msd.discriminators)
    other = build_model("HiFiGANScaleDiscriminator",
                        dict(channels=16, downsample_scales=[2, 1]))
    assert not other.use_head
    x = torch.randn(1, 64, 1, generator=torch.Generator().manual_seed(0))
    outs = other(x)
    assert [o.shape[1] for o in outs] == [64, 32, 32, 32, 32]
