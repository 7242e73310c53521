"""``export.py`` and the residual pair as a registered op, against the JAX
package on the CPU.

``to_torch_export`` of a narrow HiFi-CAR generator (frozen, as the decode
holds it) and of a MelGAN, sent through ``serialize`` / ``deserialize``:
the loaded program equals the eager forward bit for bit, holds the frozen
kernels as constants (no weight-normed parameter in its state), and JAX's
``to_stablehlo(...).serialize()`` -> ``deserialize().call`` on the same
weights (carried across by ``jax_params_to_state_dict`` /
``jax_melgan_generator_to_state_dict``) to 1e-10 in float64 (under
``jax.enable_x64``) and within 1e-5 of max |y| in float32. The HiFi-CAR
graph holds the pair op once a (stage, K, d) and none of its convolutions;
the MelGAN graph none. The op's fake kernel gives x's shape and dtype
under ``FakeTensorMode``, ``torch.library.opcheck`` passes, and
``torch.autograd.gradcheck`` holds its gradient (the plain pair
recomputed) in float64."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import export as jax_export

from articulatory_tpu.export import to_stablehlo
from articulatory_tpu.models import HiFiGANGenerator as JaxHiFiGAN
from articulatory_tpu.models import MelGANGenerator as JaxMelGAN
from articulatory_tpu_torch import export
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.ops.resblock_pair import _OP, resblock_pair_plain
from articulatory_tpu_torch.utils.weights import (
    jax_melgan_generator_to_state_dict,
    jax_params_to_state_dict,
)

torch.set_num_threads(1)
# JAX's programs compiled at XLA's lowest backend optimisation level, as
# in tests/test_torch_port_cond_train.py
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_llvm_disable_expensive_passes": True})

HIFI_CAR = dict(in_channels=13 + 8, out_channels=1, channels=16,
                kernel_size=7, upsample_scales=[5, 4],
                upsample_kernel_sizes=[10, 8], resblock_kernel_sizes=[3, 5],
                resblock_dilations=[[1, 3], [1, 3]], use_ar=True,
                ar_input=64, ar_hidden=8, ar_output=8)
PAIRS = 2 * 2 * 2  # stages x K x d
MELGAN = dict(in_channels=13, channels=32, upsample_scales=[4, 4], stacks=2)
FAMILIES = {"hifi_car": (JaxHiFiGAN, "HiFiGANGenerator", HIFI_CAR,
                         jax_params_to_state_dict),
            "melgan": (JaxMelGAN, "MelGANGenerator", MELGAN,
                       jax_melgan_generator_to_state_dict)}


def _jax_kwargs(gp):
    return {k: tuple(map(tuple, v)) if k == "resblock_dilations"
            else tuple(v) if isinstance(v, list) else v for k, v in gp.items()}


@functools.cache
def _params(name):
    """Random weights of the JAX module's shapes (``eval_shape``: nothing
    compiled), scaled by 1 / sqrt(fan in)."""
    jax_cls, _, gp, _ = FAMILIES[name]
    kwargs = {"ar": jnp.zeros((1, 64, 1))} if gp.get("use_ar") else {}
    shapes = jax.eval_shape(jax_cls(**_jax_kwargs(gp)).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 10, 13)),
                            **kwargs)["params"]
    rng = np.random.default_rng(len(name))
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) / np.sqrt(
        np.prod(s.shape[:-1]) or 1)).astype(np.float32), shapes)


def _inputs(name):
    rng = np.random.default_rng(len(name))
    c = rng.standard_normal((2, 12, 13))
    ar = 0.3 * rng.standard_normal((2, 64, 1))
    return (c, ar) if FAMILIES[name][2].get("use_ar") else (c,)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_exported_generator_matches_eager_and_jax(name, dtype):
    jax_cls, gen_type, gp, to_sd = FAMILIES[name]
    params = _params(name)
    model = build_model(gen_type, gp)
    model.load_state_dict(to_sd(params, gp))
    model = model.to(dtype).eval()
    if hasattr(model, "remove_weight_norm"):
        model.remove_weight_norm()  # the decode's frozen kernels
    inputs = tuple(torch.tensor(x, dtype=dtype) for x in _inputs(name))
    with torch.inference_mode():
        eager = model(*inputs)
    names = [k for k, _ in model.named_parameters()] + [
        k for k, _ in model.named_buffers()]
    ep = export.to_torch_export(model, inputs)
    assert export.pair_nodes(ep) == (PAIRS if name == "hifi_car" else 0)
    # the frozen kernels are the program's constants, not derived from the
    # weight-normed parameters in its graph; the model is left as it was
    assert ep.constants and not any(
        k.endswith(("weight_g", "weight_v")) for k in ep.state_dict)
    assert [k for k, _ in model.named_parameters()] + [
        k for k, _ in model.named_buffers()] == names
    if name == "hifi_car":  # the pairs' convolutions are inside the op
        convs = sorted(str(n.target) for n in ep.graph.nodes
                       if n.op == "call_function" and "conv" in str(n.target))
        # the input and output convs, the upsamplers
        assert convs == ["aten.conv1d.default"] * 2 + [
            "aten.conv_transpose1d.default"] * 2
    program = export.deserialize(export.serialize(ep)).module()
    with torch.inference_mode():
        got = program(*inputs)
        again = model(*inputs)  # the model's frozen cache outlived tracing
    torch.testing.assert_close(got, eager, rtol=0, atol=0)
    torch.testing.assert_close(again, eager, rtol=0, atol=0)

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    with jax.enable_x64(dtype == torch.float64):
        p = jax.tree.map(lambda a: jnp.asarray(a, np_dtype), params)
        xs = [jnp.asarray(x, np_dtype) for x in _inputs(name)]
        kwargs = {"ar": xs[1]} if len(xs) == 2 else {}
        blob = to_stablehlo(jax_cls(**_jax_kwargs(gp)), {"params": p},
                            (xs[0],), **kwargs).serialize()
        want = np.asarray(_jit(jax_export.deserialize(blob).call)(xs[0]))
    got = got.numpy()
    assert got.shape == want.shape
    if dtype == torch.float64:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _pair_args(dtype, requires_grad=False, t=9, c=4, k=3):
    gen = torch.Generator().manual_seed(0)
    shapes = ((2, t, c), (k, c, c), (c,), (k, c, c), (c,))
    return [(0.5 * torch.randn(s, generator=gen, dtype=dtype)
             ).requires_grad_(requires_grad) for s in shapes]


def test_pair_op_fake_kernel_and_opcheck():
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _pair_args(torch.float32)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) for a in args]
        y = _OP(*fake, 3, 0.1)
    assert y.shape == args[0].shape and y.dtype == torch.float32
    with FakeTensorMode() as mode, pytest.raises(ValueError, match="K odd"):
        _OP(*[mode.from_tensor(a) for a in _pair_args(torch.float32, k=2)],
            1, 0.1)
    torch.library.opcheck(_OP, (*args, 3, 0.1))
    torch.testing.assert_close(
        _OP(*args, 3, 0.1), resblock_pair_plain(*args, dilation=3),
        rtol=0, atol=0)


@pytest.mark.parametrize("with_bias", [True, False])
def test_pair_op_gradcheck(with_bias):
    x, w1, b1, w2, b2 = _pair_args(torch.float64, requires_grad=True)
    if not with_bias:
        b1 = b2 = None
    assert torch.autograd.gradcheck(
        lambda *a: _OP(*a, 2, 0.1), (x, w1, b1, w2, b2))
