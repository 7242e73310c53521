"""The port's HiFiGANGenerator (use_ar) against the JAX generator on the same
weights, carried across by ``jax_params_to_state_dict``; and that converter
against the JAX package's own exporter.

Small e2w shape: channels 32, upsample (5, 4, 2, 2), MRF kernels (3, 7) x
dilations (1, 3), AR 64 -> 8 -> 8, 13 feature channels."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.models import HiFiGANGenerator as JaxGenerator
from articulatory_tpu.utils.torch_export import export_hifigan_generator
from articulatory_tpu.utils.weight_norm import fold_weight_norm as jax_fold
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.utils.weights import (
    fold_weight_norm,
    jax_params_to_state_dict,
)

torch.set_num_threads(1)

GP = dict(in_channels=13 + 8, out_channels=1, channels=32, kernel_size=7,
          upsample_scales=[5, 4, 2, 2], upsample_kernel_sizes=[10, 8, 4, 4],
          resblock_kernel_sizes=[3, 7], resblock_dilations=[[1, 3], [1, 3]],
          use_additional_convs=True, use_weight_norm=True, use_ar=True,
          ar_input=64, ar_hidden=8, ar_output=8)


def _jax_kwargs(gp):
    return {k: tuple(map(tuple, v)) if k == "resblock_dilations"
            else tuple(v) if isinstance(v, list) else v for k, v in gp.items()}


@functools.cache
def _params(additional=True, use_ar=True):
    gp = dict(GP, use_additional_convs=additional, use_ar=use_ar)
    if not use_ar:
        gp["in_channels"] = 13
    model = JaxGenerator(**_jax_kwargs(gp))
    kwargs = {"ar": jnp.zeros((1, 64, 1))} if use_ar else {}
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 10, 13)), **kwargs)
    return gp, jax.device_get(variables["params"])


def _inputs(seed=0, b=2, t=20):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((b, t, 13)).astype(np.float32)
    ar = (0.3 * rng.standard_normal((b, 64, 1))).astype(np.float32)
    return c, ar


def _port(gp, params, **extra):
    model = build_model("HiFiGANGenerator", dict(gp, **extra))
    model.load_state_dict(jax_params_to_state_dict(params, gp))
    return model.eval()


def _run_port(model, c, ar):
    with torch.no_grad():
        return model(torch.from_numpy(c), torch.from_numpy(ar))


@pytest.mark.parametrize("time_packing,tol", [
    (None, dict(rtol=1e-4, atol=1e-5)),
    # the packed (space-to-depth) JAX path reorders f32 sums (~2e-4)
    ("auto", dict(rtol=2e-4, atol=2e-4)),
])
def test_generator_f32_matches_jax(time_packing, tol):
    gp, params = _params()
    c, ar = _inputs()
    jm = JaxGenerator(**_jax_kwargs(gp), time_packing=time_packing)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(c),
                                       ar=jnp.asarray(ar)))
    out = _run_port(_port(gp, params, time_packing=time_packing), c, ar)
    assert out.shape == (2, 20 * 80, 1) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **tol)


@pytest.mark.parametrize("hybrid", [True, False])
def test_generator_bf16_matches_jax(hybrid):
    """compute_dtype bfloat16, with and without hybrid precision. The port
    rounds once per fused pair where XLA rounds after every op: bound a few
    bf16 ulps of the tanh output, atol 3e-2. The output is f32 either way."""
    gp, params = _params()
    c, ar = _inputs(seed=1)
    jm = JaxGenerator(**_jax_kwargs(gp), compute_dtype=jnp.bfloat16,
                      hybrid_precision=hybrid)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(c),
                                       ar=jnp.asarray(ar)))
    model = _port(gp, params, compute_dtype="bfloat16", hybrid_precision=hybrid)
    seen = {}
    for name in ("input_conv", "blocks.0", "blocks.7"):  # first, last stage
        model.get_submodule(name).register_forward_hook(
            lambda m, args, out, name=name: seen.__setitem__(name, out.dtype))
    out = _run_port(model, c, ar)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=3e-2)
    # hybrid: the input conv and the last stage (the AR feedback path) f32
    f32_or_bf16 = torch.float32 if hybrid else torch.bfloat16
    assert seen == {"input_conv": f32_or_bf16, "blocks.0": torch.bfloat16,
                    "blocks.7": f32_or_bf16}


@pytest.mark.parametrize("additional,use_ar", [(True, True), (False, True),
                                               (True, False)])
def test_state_dict_equals_jax_export(additional, use_ar):
    gp, params = _params(additional, use_ar)
    ours = jax_params_to_state_dict(params, gp)
    ref = export_hifigan_generator(params, gp)
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        assert ours[key].dtype == torch.float32
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    # and it is exactly the port model's own parameter set
    model = build_model("HiFiGANGenerator", gp)
    assert sorted(model.state_dict()) == sorted(ours)


def test_fold_weight_norm_matches_jax_and_keeps_outputs():
    gp, params = _params()
    ref = export_hifigan_generator(jax_fold(params), gp)
    folded = fold_weight_norm(jax_params_to_state_dict(params, gp))
    for key, value in ref.items():
        np.testing.assert_allclose(folded[key].numpy(), value, rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    c, ar = _inputs(seed=2)
    model = _port(gp, params)
    before = _run_port(model, c, ar)
    model.load_state_dict(folded)
    model.remove_weight_norm()
    np.testing.assert_allclose(_run_port(model, c, ar).numpy(),
                               before.numpy(), rtol=1e-5, atol=1e-6)


def test_unported_options_raise():
    # speaker ids build since the conditioning's port
    # (tests/test_torch_port_cond_models.py), spectral norm since the
    # training path's (tests/test_torch_port_spectral_norm.py); causal
    # convs do not
    build_model("HiFiGANGenerator", dict(GP, use_spk_id=True, num_spk=2))
    build_model("HiFiGANPeriodDiscriminator",
                {"use_weight_norm": False, "use_spectral_norm": True})
    with pytest.raises(NotImplementedError):
        build_model("MelGANGenerator", {"use_causal_conv": True})
