"""int8 and bf16 weight storage of the port (``utils/quantize.py``,
``LoadedModel.quantize_int8`` / ``to_bf16_weights``) against the JAX
package's, on the CPU.

int8: the folded weights and every int8 ``q`` and float32 ``s`` equal the
JAX package's ``quantize_params_int8`` leaf for leaf after the layout map;
decoded chunks under a shared carry agree at the f32 tolerance (rtol 1e-4 /
atol 1e-5). bf16: the stored parameters equal the JAX package's bit for bit
and the effective kernels equal its weight norm evaluated eagerly in bf16;
decoded chunks agree to atol 1e-3 on tanh outputs, since the JAX package's
jitted forward lets XLA skip some bf16 roundings of that weight norm (2.5e-4
measured at this width)."""

import functools

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from articulatory_tpu import inference as jax_inference
from articulatory_tpu.models import HiFiGANGenerator as JaxGenerator
from articulatory_tpu.utils.quantize import quantize_params_int8
from articulatory_tpu.utils.weight_norm import fold_weight_norm
from articulatory_tpu_torch import inference
from articulatory_tpu_torch.utils.quantize import fold_weight_norm_, quantize_int8_
from articulatory_tpu_torch.utils.weights import jax_params_to_state_dict

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL = 1e-3


def _gp(ar_input):
    return dict(in_channels=13 + 8, out_channels=1, channels=32,
                upsample_scales=[5, 4, 2, 2], upsample_kernel_sizes=[10, 8, 4, 4],
                resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]],
                use_ar=True, ar_input=ar_input, ar_hidden=8, ar_output=8)


def _config(ar_input):
    return {"dataset_mode": "a2w", "batch_max_steps": 800, "hop_size": 80,
            "sampling_rate": 16000, "format": "npy",
            "generator_type": "HiFiGANGenerator",
            "generator_params": _gp(ar_input)}


@functools.cache
def _params(ar_input):
    gp = _gp(ar_input)
    model = JaxGenerator(**{k: tuple(map(tuple, v)) if k == "resblock_dilations"
                            else tuple(v) if isinstance(v, list) else v
                            for k, v in gp.items()})
    variables = jax.jit(model.init)(jax.random.PRNGKey(ar_input + 7),
                                    jnp.zeros((1, 10, 13)),
                                    ar=jnp.zeros((1, ar_input, 1)))
    return jax.device_get(variables["params"])


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    paths = {}
    for ar_input in (64, 2000):
        paths[ar_input] = str(root / f"ckpt_{ar_input}.pkl")
        with open(paths[ar_input], "wb") as f:
            f.write(flax.serialization.msgpack_serialize(
                {"model": {"generator": _params(ar_input)}, "steps": 1}))
    return paths


def _leaves(tree, key):
    """The tree with each int8 leaf replaced by its ``key`` array."""
    if isinstance(tree, dict):
        if set(tree) == {"int8_q", "int8_s"}:
            return tree[key]
        return {k: _leaves(v, key) for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("min_size", [64, 1024])
def test_int8_values_match_jax(ckpts, min_size):
    """Every layout (Conv1d, ConvTranspose1d, Dense) at min_size 64; the
    decode's default 1024."""
    gp = _gp(2000)
    folded = fold_weight_norm(_params(2000))
    quantized = quantize_params_int8(folded, min_size=min_size)
    want_q = jax_params_to_state_dict(_leaves(quantized, "int8_q"), gp)
    want_s = jax_params_to_state_dict(_leaves(quantized, "int8_s"), gp)
    want_folded = jax_params_to_state_dict(folded, gp)

    model = inference.load_model(ckpts[2000], _config(2000), device="cpu")
    fold_weight_norm_(model.model)
    for key, value in model.model.state_dict().items():
        torch.testing.assert_close(value, want_folded[key], rtol=0, atol=0)
    names = quantize_int8_(model.model, min_size=min_size)
    expected = sorted(k for k, v in want_q.items() if v.dtype == torch.int8)
    assert sorted(names) == expected and len(names) >= 3
    if min_size == 64:  # every layout is among them
        assert {n.split(".")[0] for n in names} >= {
            "input_conv", "upsamples", "blocks", "ar_model"}
    buffers = dict(model.model.named_buffers())
    for name in names:
        q, s = buffers[f"{name}_int8"], buffers[f"{name}_scale"]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        torch.testing.assert_close(q, want_q[name], rtol=0, atol=0)
        torch.testing.assert_close(s, want_s[name], rtol=0, atol=0)


def _chunks(jax_model, model, ar_input, atol, rtol):
    """Four chunks, both sides from the JAX side's carry."""
    rng = np.random.default_rng(ar_input)
    x = rng.standard_normal((2, 40, 13)).astype(np.float32)
    prev = jnp.zeros((2, ar_input, 1))
    for i in range(4):
        cin = x[:, i * 10:(i + 1) * 10]
        ref = np.asarray(jax_model(jnp.asarray(cin), ar=prev))
        out = model(cin, ar=np.array(prev)).numpy()
        np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol,
                                   err_msg=f"chunk {i}")
        prev = (jnp.asarray(ref)[:, -ar_input:] if ar_input <= 800 else
                jnp.concatenate([prev[:, ref.shape[1]:], jnp.asarray(ref)], 1))


@pytest.mark.parametrize("ar_input", [64, 2000])
def test_int8_decode_matches_jax(ckpts, ar_input):
    jax_model = jax_inference.load_model(ckpts[ar_input], _config(ar_input))
    jax_model.quantize_int8()
    model = inference.load_model(ckpts[ar_input], _config(ar_input),
                                 device="cpu")
    model.quantize_int8()
    assert model.quantized
    _chunks(jax_model, model, ar_input, **TOL)
    # load_model honours weight_quant: int8 and refuses other schemes
    config = dict(_config(ar_input), weight_quant="int8")
    again = inference.load_model(ckpts[ar_input], config, device="cpu")
    assert again.quantized
    with pytest.raises(ValueError):
        inference.load_model(ckpts[ar_input], dict(config, weight_quant="int4"),
                             device="cpu")
    with pytest.raises(ValueError):
        again.to_bf16_weights()


@pytest.mark.parametrize("ar_input", [64, 2000])
def test_bf16_weights_match_jax(ckpts, ar_input):
    jax_model = jax_inference.load_model(ckpts[ar_input], _config(ar_input))
    jax_model.to_bf16_weights()
    model = inference.load_model(ckpts[ar_input], _config(ar_input),
                                 device="cpu")
    model.to_bf16_weights()
    stored = jax.tree.map(lambda a: np.asarray(a, np.float32), jax_model.params)
    want = jax_params_to_state_dict(stored, _gp(ar_input))
    for key, value in model.model.state_dict().items():
        assert value.dtype == torch.bfloat16, key
        torch.testing.assert_close(value.float(), want[key], rtol=0, atol=0)
    # the input conv's kernel: the JAX package's weight norm, eagerly in bf16
    p = jax_model.params["input_conv"]
    v, g = jnp.asarray(p["v"]), jnp.asarray(p["g"])
    w = g * v / jnp.sqrt(jnp.sum(jnp.square(v), axis=(0, 1), keepdims=True))
    kernel, _ = model.model.input_conv.kernel(torch.float32)
    np.testing.assert_array_equal(kernel.numpy(), np.asarray(w, np.float32))
    _chunks(jax_model, model, ar_input, atol=BF16_ATOL, rtol=0)
