"""int8 and bf16 weight storage of every family of the zoo against the JAX
package's, on the CPU: the BiGRU (AR on), the Transformer (with and
without a phoneme embedding), MelGAN, Parallel WaveGAN, GBlock,
StyleMelGAN and the multi-band HiFi-GAN.

int8 (``utils/quantize.py::quantize_int8_``, ``LoadedModel.quantize_int8``):
the folded weights and every int8 ``q`` and float32 ``s`` equal JAX's
``quantize_params_int8`` leaf for leaf after the port's layout map (at
``min_size`` 64, where every layout is quantized, and at the decode's
1024); leaves JAX leaves in float (Parallel WaveGAN's 4-d upsampling
kernel, biases, norms) stay float; the forward after
``LoadedModel.quantize_int8`` matches the JAX module on its dequantized
tree (rtol 1e-4 / atol 1e-5). bf16 (``LoadedModel.to_bf16_weights``): the
stored values equal JAX's bf16 tree bit for bit (a GRU's also in its
float32 flat weights), the BatchNorm statistics stay float32 (JAX's
mutables), and the forward matches the JAX module on the bf16 tree to atol
1e-3. Parallel WaveGAN's reference runs op by op (``jax.disable_jit``):
jitted, XLA skips some bf16 roundings of the weight norm, which moves its
unsquashed output by 1.2e-2 from the eager one, where the port is within
1e-6 of the eager one; and its 4-d upsampling kernel is handed to JAX
upcast, since JAX's bf16 conv2d refuses the float32 features (JAX's own
bf16 storage cannot run the model; the port upcasts the stored kernel). A
phoneme table in bf16 makes both packages run the Transformer in bf16, so
there the port is held within twice JAX's own bf16 error against its
float32 forward. Noise-driven families get the same noise on both
sides."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from articulatory_tpu import models as jax_models
from articulatory_tpu.utils.quantize import (
    dequantize_params,
    quantize_params_int8,
)
from articulatory_tpu.utils.weight_norm import fold_weight_norm
from articulatory_tpu_torch import inference
from articulatory_tpu_torch.utils.quantize import (
    fold_weight_norm_,
    quantize_int8_,
)
from articulatory_tpu_torch.utils.weights import generator_to_state_dict

torch.set_num_threads(1)
# JAX's programs compiled at XLA's lowest backend optimisation level, as
# in tests/test_torch_port_cond_train.py
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_llvm_disable_expensive_passes": True})
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL = 1e-3


@dataclasses.dataclass
class Family:
    gen_type: str
    gp: dict
    inputs: dict  # shapes; "ids" an int range for phoneme ids
    kwargs: tuple = ()  # inputs passed by keyword (JAX) / position (port)


FAMILIES = {
    "bigru": Family("BiGRU", dict(in_channels=5 + 8, hidden_size=16,
                                  out_channels=4, dropout=0.0, use_ar=True,
                                  ar_input=64, ar_hidden=8, ar_output=8),
                    {"x": (2, 20, 5), "ar": (2, 16, 4)}, ("ar",)),
    "transformer": Family("Transformer", dict(in_channels=5, out_channels=4,
                                              hidden_dim=32, elayers=1,
                                              dropout=0.0),
                          {"x": (2, 12, 5)}),
    "transformer_ph": Family("Transformer", dict(
        in_channels=5, out_channels=4, hidden_dim=32, elayers=1,
        dropout=0.0, num_ph=40, ph_emb_size=32), {"x": ("ids", 2, 12, 40)}),
    "melgan": Family("MelGANGenerator", dict(in_channels=13, channels=64,
                                             upsample_scales=[4, 4],
                                             stacks=2),
                     {"c": (2, 10, 13)}),
    "pwg": Family("ParallelWaveGANGenerator", dict(
        layers=4, stacks=2, residual_channels=16, gate_channels=32,
        skip_channels=16, aux_channels=13, aux_context_window=2,
        upsample_params={"upsample_scales": [4, 4]}),
        {"noise": (2, 160, 1), "c": (2, 14, 13)}),
    "gblock": Family("GBlockGenerator", dict(in_channels=13, channels=32,
                                             g_scales=[4, 4],
                                             g_kernel_sizes=[9, 9]),
                     {"c": (2, 10, 13)}),
    "style_melgan": Family("StyleMelGANGenerator", dict(
        in_channels=8, aux_channels=10, channels=32,
        noise_upsample_scales=[4, 4], upsample_scales=[2, 2, 2]),
        {"c": (2, 16, 10), "z": (2, 1, 8)}),
    "multiband": Family("HiFiGANGenerator", dict(
        in_channels=13, out_channels=4, channels=32, kernel_size=7,
        upsample_scales=[5, 2, 2], upsample_kernel_sizes=[10, 4, 4],
        resblock_kernel_sizes=[3, 5], resblock_dilations=[[1, 3], [1, 3]]),
        {"c": (2, 10, 13)}),
}
NAMES = sorted(FAMILIES)


def _tuples(v):
    if isinstance(v, list):
        return tuple(_tuples(x) for x in v)
    if isinstance(v, dict):
        return {k: _tuples(x) for k, x in v.items()}
    return v


@functools.cache
def _inputs(name):
    rng = np.random.default_rng(len(name))
    out = {}
    for key, shape in FAMILIES[name].inputs.items():
        if shape[0] == "ids":
            out[key] = rng.integers(0, shape[-1], shape[1:-1])
        else:
            out[key] = rng.standard_normal(shape).astype(np.float32)
    return out


def _jax_args(name, inputs):
    fam = FAMILIES[name]
    args = [jnp.asarray(v) for k, v in inputs.items() if k not in fam.kwargs]
    kwargs = {k: jnp.asarray(inputs[k]) for k in fam.kwargs}
    return args, kwargs


@functools.cache
def _jax(name):
    """The JAX module, params and mutables (BatchNorm statistics moved off
    their init)."""
    fam = FAMILIES[name]
    module = jax_models.build_model(fam.gen_type, _tuples(fam.gp))
    args, kwargs = _jax_args(name, _inputs(name))
    variables = jax.device_get(_jit(functools.partial(
        module.init, **kwargs))(jax.random.PRNGKey(1), *args))
    rng = np.random.default_rng(7)

    def move(path, leaf):
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return (rng.standard_normal(leaf.shape) * 0.3).astype(np.float32)

    mutables = {k: jax.tree_util.tree_map_with_path(move, v)
                for k, v in variables.items() if k != "params"}
    return module, variables["params"], mutables


def _config(name):
    fam = FAMILIES[name]
    return {"dataset_mode": "w2a" if fam.gen_type in ("BiGRU", "Transformer")
            else "a2w", "hop_size": 16, "sampling_rate": 16000,
            "batch_max_steps": 160, "format": "npy",
            "generator_type": fam.gen_type, "generator_params": fam.gp}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("storage_zoo")
    paths = {}
    for name in NAMES:
        _, params, mutables = _jax(name)
        paths[name] = str(root / f"{name}.pkl")
        with open(paths[name], "wb") as f:
            f.write(flax.serialization.msgpack_serialize(
                {"model": {"generator": params},
                 "mutables": {"generator": mutables}, "steps": 1}))
    return paths


def _leaves(tree, key):
    """The tree with each int8 leaf replaced by its ``key`` array."""
    if isinstance(tree, dict):
        if set(tree) == {"int8_q", "int8_s"}:
            return tree[key]
        return {k: _leaves(v, key) for k, v in tree.items()}
    return tree


def _state(name, params, mutables):
    """JAX params in the port's keys; a Parallel WaveGAN's upsampling
    kernel as the port keeps it (``weight``, not a weight-norm pair)."""
    fam = FAMILIES[name]
    sd = generator_to_state_dict(fam.gen_type, params, mutables, fam.gp,
                                 steps=1)  # the checkpoint's step
    if fam.gen_type == "ParallelWaveGANGenerator":
        ups = params["upsample_net"]["upsample"]
        for i in range(len(fam.gp["upsample_params"]["upsample_scales"])):
            prefix = f"upsample_net.upsample.up_layers.{1 + 2 * i}"
            del sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]
            sd[f"{prefix}.weight"] = torch.tensor(np.transpose(
                np.asarray(ups[f"conv_{i}_w"]), (3, 2, 0, 1)).copy())
    return sd


def _port_forward(model, name):
    inputs = _inputs(name)
    with torch.inference_mode():
        return model.model(*[torch.as_tensor(v) for v in inputs.values()]
                           ).float().numpy()


def _jax_forward(name, params):
    module, _, mutables = _jax(name)
    args, kwargs = _jax_args(name, _inputs(name))
    out = _jit(functools.partial(module.apply, **kwargs))(
        {"params": params, **mutables}, *args)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("min_size", [64, 1024])
@pytest.mark.parametrize("name", NAMES)
def test_int8_values_match_jax(ckpts, name, min_size):
    _, params, mutables = _jax(name)
    folded = fold_weight_norm(params)
    quantized = quantize_params_int8(folded, min_size=min_size)
    want_q = _state(name, _leaves(quantized, "int8_q"), mutables)
    want_s = _state(name, _leaves(quantized, "int8_s"), mutables)
    model = inference.load_model(ckpts[name], _config(name), device="cpu")
    fold_weight_norm_(model.model)
    for key, value in _state(name, folded, mutables).items():
        torch.testing.assert_close(model.model.state_dict()[key], value,
                                   rtol=0, atol=0, msg=key)
    names = quantize_int8_(model.model, min_size=min_size)
    expected = sorted(k for k, v in want_q.items() if v.dtype == torch.int8)
    assert sorted(names) == expected and names
    buffers = dict(model.model.named_buffers())
    for key in names:
        q, s = buffers[f"{key}_int8"], buffers[f"{key}_scale"]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        torch.testing.assert_close(q, want_q[key], rtol=0, atol=0)
        torch.testing.assert_close(s, want_s[key], rtol=0, atol=0)
    # what JAX leaves in float stays a float parameter here
    floats = {k for k, _ in model.model.named_parameters()}
    for key, value in want_q.items():
        if value.is_floating_point() and key in floats:
            assert model.model.state_dict()[key].is_floating_point()
    if min_size == 64:  # the layouts of the family are all among them
        kinds = {"bigru": ("gru1.weight_ih_l0", "gru2.weight_hh_l0_reverse",
                           "fc1.0.weight", "ar_model.model.0.weight"),
                 "transformer": ("transformer.layers.0.self_attn.w_q",
                                 "transformer.layers.0.self_attn.w_o",
                                 "transformer.layers.0.self_attn."
                                 "relative_positional.embeddings",
                                 "transformer.layers.0.linear1.weight"),
                 "transformer_ph": ("in_emb_mat.weight",),
                 "melgan": ("melgan.3.weight_v",),
                 "style_melgan": ("noise_upsample.0.weight_v",)}
        assert set(kinds.get(name, ())) <= set(names)
    if name == "pwg":
        assert "upsample_net.upsample.up_layers.1.weight" in floats


@pytest.mark.parametrize("name", NAMES)
def test_int8_forward_matches_jax(ckpts, name):
    _, params, _ = _jax(name)
    want = _jax_forward(name, dequantize_params(
        quantize_params_int8(fold_weight_norm(params))))
    model = inference.load_model(ckpts[name], _config(name), device="cpu")
    model.quantize_int8()
    assert model.quantized
    got = _port_forward(model, name)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    again = _port_forward(model, name)  # from the frozen (cached) weights
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_matches_jax(ckpts, name):
    _, params, mutables = _jax(name)
    stored = jax.tree.map(lambda a: np.asarray(a, jnp.bfloat16),
                          fold_weight_norm(params))
    model = inference.load_model(ckpts[name], _config(name), device="cpu")
    model.to_bf16_weights()
    want = _state(name, jax.tree.map(lambda a: np.asarray(a, np.float32),
                                     stored), mutables)
    state = model.model.state_dict()
    for key, value in want.items():
        torch.testing.assert_close(state[key].to(value.dtype), value, rtol=0,
                                   atol=0, msg=key)
        if "running" in key or "num_batches" in key:  # JAX's mutables
            assert state[key].dtype == value.dtype, key
        elif key.startswith("gru"):  # float32 flat weights, bf16 values
            assert state[key].dtype == torch.float32, key
            assert state[f"{key}_bf16"].dtype == torch.bfloat16, key
        else:
            assert state[key].dtype == torch.bfloat16, key
    got = _port_forward(model, name)
    tree = jax.tree.map(jnp.asarray, stored)
    if name == "pwg":  # JAX's own bf16 conv2d refuses an f32 input
        ups = tree["upsample_net"]["upsample"]
        for key in ups:
            ups[key] = ups[key].astype(jnp.float32)
    # op by op, every bf16 rounding is made, as in the port; jitted, XLA
    # skips some (PWG's output moves by 1.2e-2), so PWG's runs eagerly
    with jax.disable_jit(name == "pwg"):
        ref = _jax_forward(name, tree)
    assert got.shape == ref.shape
    if name != "transformer_ph":
        np.testing.assert_allclose(got, ref, rtol=0, atol=BF16_ATOL)
        return
    # the bf16 table makes both packages run the whole model in bf16:
    # within twice JAX's own bf16 error against its f32 forward
    f32 = _jax_forward(name, jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float32), stored))
    limit = 2 * np.abs(ref - f32).max()
    assert np.abs(got - ref).max() <= limit, (np.abs(got - ref).max(), limit)
