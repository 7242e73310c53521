"""The fused residual pair and the residual block against the JAX package.

``resblock_pair_plain`` (what a CPU tensor runs, and the kernel's yardstick
on the card) is held against ``resblock_pair_reference`` and the Pallas
kernel in interpret mode at rtol/atol 1e-4, test_pallas_resblock.py's own
tolerance. The port's ``HiFiGANResidualBlock`` is held against the JAX block
on the same weights: with ``use_additional_convs`` each dilation is one pair,
which shows the pair decomposition is exact (f32, rtol/atol 1e-5)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.layers.residual import HiFiGANResidualBlock as JaxBlock
from articulatory_tpu.ops.pallas.resblock import (
    resblock_pair_pallas,
    resblock_pair_reference,
)
from articulatory_tpu.utils.torch_export import _Flat
from articulatory_tpu_torch.layers.residual import HiFiGANResidualBlock
from articulatory_tpu_torch.ops.resblock_pair import (
    resblock_pair,
    resblock_pair_plain,
)

torch.set_num_threads(1)


def _pair_inputs(rng, t, c, k):
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    w1 = (rng.standard_normal((k, c, c)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((k, c, c)) * 0.1).astype(np.float32)
    b1 = rng.standard_normal((c,)).astype(np.float32)
    b2 = rng.standard_normal((c,)).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("dilation", [1, 3, 5])
def test_plain_matches_reference_and_pallas(k, dilation):
    # T = 256 is a whole number of the Pallas kernel's 128-row tiles
    args = _pair_inputs(np.random.default_rng(10 * k + dilation), 256, 32, k)
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(resblock_pair_reference(*jargs, dilation=dilation))
    pallas = np.asarray(resblock_pair_pallas(*jargs, dilation=dilation,
                                             t_tile=128, interpret=True))
    out = resblock_pair_plain(*map(torch.from_numpy, args),
                              dilation=dilation).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, pallas, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t,k,dilation", [(300, 11, 5), (7, 7, 3), (1, 3, 1)])
def test_plain_ragged_length_matches_reference(t, k, dilation):
    # lengths the Pallas kernel does not take (T % t_tile != 0), down to T = 1
    args = _pair_inputs(np.random.default_rng(t), t, 16, k)
    ref = np.asarray(resblock_pair_reference(*map(jnp.asarray, args),
                                             dilation=dilation))
    out = resblock_pair(*map(torch.from_numpy, args), dilation=dilation)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_cpu_tensor_launches_no_kernel():
    args = _pair_inputs(np.random.default_rng(0), 20, 8, 3)
    before = resblock_pair.launches
    resblock_pair(*map(torch.from_numpy, args), dilation=3)
    assert resblock_pair.launches == before


def _jax_block_and_port(kernel_size, dilations, additional, channels=12):
    rng = np.random.default_rng(kernel_size)
    x = rng.standard_normal((2, 40, channels)).astype(np.float32)
    jblock = JaxBlock(kernel_size=kernel_size, channels=channels,
                      dilations=dilations, use_additional_convs=additional)
    params = jax.device_get(
        jblock.init(jax.random.PRNGKey(kernel_size), jnp.asarray(x))["params"])
    flat = _Flat()
    for i in range(len(dilations)):
        flat.conv1d(f"convs1.{i}.1", params[f"convs1_{i}"])
        if additional:
            flat.conv1d(f"convs2.{i}.1", params[f"convs2_{i}"])
    block = HiFiGANResidualBlock(kernel_size=kernel_size, channels=channels,
                                 dilations=dilations,
                                 use_additional_convs=additional)
    block.load_state_dict({k: torch.tensor(v) for k, v in flat.sd.items()})
    return jblock, params, block, x


@pytest.mark.parametrize("kernel_size,dilations,additional", [
    (3, (1, 3, 5), True), (11, (1, 3, 5), True), (7, (1, 3), False)])
def test_residual_block_matches_jax(kernel_size, dilations, additional):
    jblock, params, block, x = _jax_block_and_port(kernel_size, dilations,
                                                   additional)
    ref = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = block(torch.from_numpy(x)).numpy()
        block.convs1[0][1].remove_weight_norm()  # cached kernel, same output
        again = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(again, out)


def test_residual_block_bf16_matches_jax():
    """bf16 compute (the hybrid interior): the kernel path rounds h and the
    output once each where XLA rounds after every op, so the bound is a few
    bf16 ulps of |x| <~ 4: atol 6e-2."""
    jblock, params, block, x = _jax_block_and_port(7, (1, 3, 5), True)
    jb = JaxBlock(kernel_size=7, channels=12, dilations=(1, 3, 5),
                  compute_dtype=jnp.bfloat16)
    ref = np.asarray(jb.apply({"params": params},
                              jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        out = block(torch.from_numpy(x), torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=6e-2)
