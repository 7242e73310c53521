"""Resuming every optimizer of the JAX package's ``build_optimizer`` from its
optax state: JAX takes three updates of a HiFi-GAN generator's parameters
(float64, seeded gradients), the port's ``load_optax_state`` carries that
state into ``torch.optim`` through the weights' converter
(``utils/checkpoint.py::optax_moments``), and both take one more update on
the same gradient; the parameters then agree to 1e-10 (Adam and AdamW are
``tests/test_torch_port_trainer_extras.py``'s). Each optimizer runs with
the options that give it state to carry (momentum, a centred average,
weight decay, an accumulator's initial value). The JAX trees come from
``jax.eval_shape`` of the model's init, and each optax update is compiled at
XLA's lowest optimisation level. JAX's Adagrad, Adamax, NAdam and ASGD
rules cast their step count (and NAdam its ``mu_product``) to float32 even
under x64, which leaves their float64 updates 1e-9 to 1e-7 from torch's;
the test hands the rules a ``jnp`` whose float32 is float64, as the zoo's
tests hand JAX's PQMF its filters in float64, so the same rules run in
float64; torch keeps its scalars (ASGD's ``eta``) in the default dtype,
which the test sets to float64 for the port's side. ASGD's averaged iterate, which optax does not keep, is refused
past ``t0`` + 2 updates, naming ASGD."""

import functools
import unittest.mock

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from articulatory_tpu import models as jax_models
from articulatory_tpu.train import optimizers as jax_optimizers
from articulatory_tpu.train.optimizers import build_optimizer as jax_optimizer
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.train.optimizers import (
    build_optimizer,
    load_optax_state,
)
from articulatory_tpu_torch.utils.checkpoint import optax_moments
from articulatory_tpu_torch.utils.weights import jax_params_to_state_dict

torch.set_num_threads(1)

# one stage (15 parameter tensors: every kind of conv the converter maps;
# the AR encoder's dense layers are Adam's case in trainer_extras)
GP = dict(in_channels=13, out_channels=1, channels=16, kernel_size=7,
          upsample_scales=[4], upsample_kernel_sizes=[8],
          resblock_kernel_sizes=[3], resblock_dilations=[[1]])
CONFIG = dict(generator_type="HiFiGANGenerator", generator_params=GP)
LR = 1e-2
WD = dict(weight_decay=1e-2)
OPTIMIZERS = {
    "RAdam": dict(WD),
    "NAdam": dict(WD),
    "SGD": dict(WD, momentum=0.9, nesterov=True),
    "RMSprop": dict(WD, momentum=0.5, centered=True),
    "Adagrad": dict(WD, lr_decay=1e-2, initial_accumulator_value=0.1),
    "Adadelta": dict(WD, rho=0.8),
    "Adamax": dict(WD),
    "ASGD": dict(WD, lambd=1e-2),
    "Rprop": dict(etas=(0.4, 1.3)),
}


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` standing for ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@functools.cache
def _shapes():
    gen = jax_models.build_model("HiFiGANGenerator", GP)
    return jax.eval_shape(lambda: gen.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 10, 13), jnp.float32)))["params"]


def _random_like(tree, rng, scale=1.0):
    return jax.tree.map(lambda s: scale * rng.standard_normal(s.shape), tree)


def _jax_updates(name, params, n):
    """JAX's parameters after ``n`` updates from seeded gradients, its
    parameters and optax state after each of the first ``n - 1`` (lists
    indexed by the updates taken), and the last gradient."""
    with jax.enable_x64(True), unittest.mock.patch.object(
            jax_optimizers, "jnp", _Float64Numpy()):
        return _jax_updates_f64(name, params, n)


def _jax_updates_f64(name, params, n):
    rng = np.random.default_rng(1)
    tx = jax_optimizer(name, dict(params, lr=LR))

    def update(p, state, grads):
        updates, state = tx.update(grads, state, p)
        return optax.apply_updates(p, jax.tree.map(lambda u: -LR * u,
                                                   updates)), state

    update = jax.jit(update, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})
    tree = _random_like(_shapes(), np.random.default_rng(0), 0.1)
    state = tx.init(tree)
    trees, states = [], []
    for _ in range(n):
        grads = _random_like(tree, rng)
        trees.append(tree)
        states.append(jax.tree.map(np.asarray,
                                   flax.serialization.to_state_dict(state)))
        tree, state = update(tree, state, grads)
    return trees, states, grads, tree


@pytest.fixture(autouse=True)
def _float64_default():
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(default)


def _port_resume(name, params, before, saved, updates):
    gen = build_model("HiFiGANGenerator", GP).double()
    gen.load_state_dict(jax_params_to_state_dict(before, GP))
    opt = build_optimizer(name, dict(params, lr=LR), -1, gen.parameters())
    moments = optax_moments({"model": {"generator": before}}, "generator",
                            CONFIG, gen)
    load_optax_state(opt, name, saved, moments, gen, updates=updates)
    return gen, opt, moments


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optax_state_resumes_in_torch(name):
    params = OPTIMIZERS[name]
    trees, states, grads, want = _jax_updates(name, params, 4)
    gen, opt, moments = _port_resume(name, params, trees[3], states[3], 3)
    for key, g in moments(grads).items():
        dict(gen.named_parameters())[key].grad = g.double()
    opt.step(LR)
    steps = {int(s["step"]) for s in opt.optimizer.state.values()
             if "step" in s}
    assert steps == (set() if name == "SGD" else {4})
    want = jax_params_to_state_dict(want, GP)
    for key, p in gen.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(),
                                   rtol=0, atol=1e-10, err_msg=key)


def test_asgd_average_past_t0_is_refused():
    params = dict(OPTIMIZERS["ASGD"], t0=0)
    trees, states, _, _ = _jax_updates("ASGD", params, 4)
    with pytest.raises(NotImplementedError, match="ASGD"):
        _port_resume("ASGD", params, trees[3], states[3], 3)
    _port_resume("ASGD", params, trees[2], states[2], 2)  # ax is still p
