"""Pipeline parallelism: ``HiFiGANGenerator.run_stages`` of the port against
the JAX package's on the same weights (float64, 1e-10), chained ranges
against the port's forward bit for bit, ``PipelinedGenerator`` on
``["cpu", "cpu"]`` against the monolith, and the JAX package's validation
cases. The widths are ``tests/test_pipeline_parallel.py``'s."""

import functools
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.models import HiFiGANGenerator as JaxGenerator
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.parallel.pp import (
    PipelinedGenerator,
    even_boundaries,
    stage_param_subset,
)
from articulatory_tpu_torch.utils.weights import jax_params_to_state_dict

torch.set_num_threads(1)

GP = dict(in_channels=13 + 16, out_channels=1, channels=32, kernel_size=7,
          upsample_scales=[5, 4, 2, 2], upsample_kernel_sizes=[10, 8, 4, 4],
          resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]],
          use_ar=True, ar_input=64, ar_hidden=16, ar_output=16)
_jit = functools.partial(jax.jit, static_argnums=(2, 3), compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_llvm_disable_expensive_passes": True})


def _jax_kwargs(gp):
    return {k: tuple(map(tuple, v)) if k == "resblock_dilations"
            else tuple(v) if isinstance(v, list) else v for k, v in gp.items()}


def _inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((4, 20, 13)),
            rng.standard_normal((4, 64, 1)) * 0.1)


@functools.cache
def _params():
    model = JaxGenerator(**_jax_kwargs(GP))
    with jax.enable_x64(True):
        c, ar = (jnp.asarray(a) for a in _inputs())
        variables = jax.jit(model.init)(jax.random.PRNGKey(0), c, ar=ar)
    return jax.device_get(variables["params"])


def _port(dtype=torch.float64):
    model = build_model("HiFiGANGenerator", GP)
    model.load_state_dict(jax_params_to_state_dict(_params(), GP))
    return model.to(dtype).eval()


def _port_inputs(dtype=torch.float64):
    c, ar = _inputs()
    return torch.tensor(c, dtype=dtype), torch.tensor(ar, dtype=dtype)


RANGES = [(0, 2), (2, 5), (5, 6), (0, 6)]


def test_run_stages_match_jax():
    """Each range of stages on the same handoff, float64."""
    model, n = _port(), 6
    assert model.num_pipeline_stages == n
    jm = JaxGenerator(**_jax_kwargs(GP))
    c, ar = _port_inputs()
    with torch.no_grad():  # the handoffs into every stage
        acts = [c]
        for s in range(n):
            acts.append(model.run_stages(acts[-1], s, s + 1,
                                         ar=ar if s == 0 else None))
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _params())

        def apply(params, x, start, stop, ar):
            return jm.apply({"params": params}, x, start, stop,
                            method="run_stages", ar=ar)

        fn = _jit(apply)
        for start, stop in RANGES:
            want = np.asarray(fn(params, jnp.asarray(acts[start].numpy()),
                                 start, stop,
                                 jnp.asarray(ar.numpy()) if start == 0
                                 else None))
            with torch.no_grad():
                got = model.run_stages(acts[start], start, stop,
                                       ar=ar if start == 0 else None).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10,
                                       err_msg=f"[{start}, {stop})")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chained_stages_are_the_forward(dtype):
    model, n = _port(dtype), 6
    c, ar = _port_inputs(dtype)
    with torch.no_grad():
        full = model(c, ar)
        for bounds in ([0, 1, n], [0, 3, n], [0, 2, 4, n],
                       even_boundaries(n, n)):
            x = c
            for start, stop in zip(bounds, bounds[1:]):
                x = model.run_stages(x, start, stop,
                                     ar=ar if start == 0 else None)
            assert torch.equal(x, full), bounds


def test_stage_param_subsets_partition_params():
    model = _port()
    bounds = even_boundaries(model.num_pipeline_stages, 3)
    seen = []
    for start, stop in zip(bounds, bounds[1:]):
        seen.extend(stage_param_subset(model, start, stop))
    assert sorted(seen) == sorted(model.state_dict())


@pytest.mark.parametrize("devices,boundaries,microbatches", [
    (["cpu", "cpu"], None, 2),
    (["cpu", "cpu"], [0, 1, 6], 1),
    (["cpu"] * 3, None, 4),
], ids=["two_groups", "custom_bounds", "three_groups"])
def test_pipelined_generator_matches_monolith(devices, boundaries,
                                              microbatches):
    model = _port()
    c, ar = _port_inputs()
    pipe = PipelinedGenerator(model, devices, boundaries=boundaries,
                              num_microbatches=microbatches)
    out = pipe(c, ar)
    with torch.no_grad():
        full = model(c, ar)
        # microbatch for microbatch, the monolith's forward
        parts = torch.cat([model(a, b) for a, b in zip(
            c.chunk(microbatches), ar.chunk(microbatches))])
    assert torch.equal(out, parts)
    np.testing.assert_allclose(out.numpy(), full.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_pipelined_generator_positional_order_matches_model():
    model = _port()
    pipe_params = list(inspect.signature(
        PipelinedGenerator.__call__).parameters)[1:]
    model_params = list(inspect.signature(model.forward).parameters)
    assert pipe_params == model_params
    c, ar = _port_inputs()
    with torch.no_grad():
        assert torch.equal(PipelinedGenerator(model, ["cpu", "cpu"])(c, ar),
                           torch.cat([model(a, b) for a, b in zip(
                               c.chunk(2), ar.chunk(2))]))


@pytest.mark.parametrize("start,stop", [(0, 0), (3, 2), (0, 7), (-1, 6),
                                        (6, 6)])
def test_run_stages_rejects_bad_ranges(start, stop):
    model = _port()
    c, ar = _port_inputs()
    with pytest.raises(ValueError):
        model.run_stages(c, start, stop, ar=ar if start == 0 else None)


def test_even_boundaries():
    assert even_boundaries(6, 3) == [0, 2, 4, 6]
    assert even_boundaries(6, 4) == [0, 2, 4, 5, 6]
    assert even_boundaries(6, 1) == [0, 6]
    assert even_boundaries(6, 6) == [0, 1, 2, 3, 4, 5, 6]
    for bad in (7, 0):
        with pytest.raises(ValueError):
            even_boundaries(6, bad)


@pytest.mark.parametrize("case", ["short_boundaries", "no_microbatches",
                                  "indivisible_batch", "ph_loss"])
def test_pipelined_generator_validation(case):
    model = _port()
    c, ar = _port_inputs()
    devices = ["cpu", "cpu"]
    with pytest.raises(ValueError):
        if case == "short_boundaries":
            PipelinedGenerator(model, devices, boundaries=[0, 2])
        elif case == "no_microbatches":
            PipelinedGenerator(model, devices, num_microbatches=0)
        elif case == "indivisible_batch":  # batch 4, 3 microbatches
            PipelinedGenerator(model, devices, num_microbatches=3)(c, ar)
        else:
            PipelinedGenerator(build_model("HiFiGANGenerator", dict(
                GP, use_ph_loss=True, num_ph=5)), devices)
