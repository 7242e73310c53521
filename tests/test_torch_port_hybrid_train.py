"""Hybrid bf16 training and ``use_remat``: one step of the port's
``train/gan.py`` against the JAX package's ``make_train_step`` on the same
weights and batch, with ``tests/test_hybrid_training.py``'s configuration
(an AR HiFi-GAN of two stages at 32 channels, STFT and feature-matching
losses, a small MSMPD; for the bf16 discriminator one whose scale stack
has the head's shape, 1 -> 128 channels, kernels 15 and 41: the
``scale_disc_head`` path).

- Hybrid (``compute_dtype: bfloat16``, ``hybrid_precision: true``): the
  first stage's pairs run in bf16 and the input conv, the last stage and
  the output conv in f32, the parameters stay f32 and take f32 updates.
  Both packages step with SGD, so an update is -lr x the gradient. Each
  model's gradient is held to JAX's hybrid one in relative L2 pooled over
  its tensors, within twice JAX's own hybrid gradient's distance from its
  f32 one (two bf16 estimates, each that far from the f32 gradient, can be
  twice as far apart: the port rounds once per fused pair where XLA rounds
  after every op; the port's f32 gradients stand in for JAX's, which they
  equal to ~1e-5, ``tests/test_torch_port_train.py``); the metrics to rtol
  4e-3, one bf16 ulp. Also with the bf16 discriminator
  (``discriminator_params.compute_dtype``), whose feature maps come back
  f32.
- ``use_remat``: in float64 the step equals the step without remat to
  1e-10 and JAX's ``use_remat`` step to 1e-8, and the generator's forward
  runs once more (its recompute in the backward); a generator with
  BatchNorm statistics is not rematerialised, as in JAX.

JAX's programs compile at XLA's lowest backend optimisation level."""

import functools
import unittest.mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu import models as jax_models
from articulatory_tpu.train import gan as jgan
from articulatory_tpu.train.optimizers import build_optimizer as jax_optimizer
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.train import gan
from articulatory_tpu_torch.train.optimizers import build_optimizer
from articulatory_tpu_torch.utils import weights

torch.set_num_threads(1)

_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_llvm_disable_expensive_passes": True})
LR = 1e-2
GP = dict(in_channels=13 + 8, channels=32, kernel_size=7,
          upsample_scales=[4, 4], upsample_kernel_sizes=[8, 8],
          resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]],
          use_ar=True, ar_input=64, ar_hidden=8, ar_output=8)
DP = dict(scales=1, scale_discriminator_params=dict(
    channels=128, max_downsample_channels=128, max_groups=16,
    downsample_scales=[4, 1]), periods=[2],
    period_discriminator_params=dict(channels=2, max_downsample_channels=4))
CONFIG = dict(
    dataset_mode="a2w", batch_max_steps=800, hop_size=16,
    use_stft_loss=True, stft_loss_params=dict(
        fft_sizes=[128], hop_sizes=[32], win_lengths=[64]),
    use_mel_loss=False, use_feat_match_loss=True,
    generator_adv_loss_params=dict(average_by_discriminators=True),
    discriminator_adv_loss_params=dict(average_by_discriminators=True),
    lambda_aux=1.0, lambda_adv=1.0, lambda_feat_match=2.0,
    generator_train_start_steps=0, discriminator_train_start_steps=0,
    generator_type="HiFiGANGenerator", generator_params=GP,
    discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
    discriminator_params=DP)
# the generator's cases' discriminator, and the remat cases' in float64:
# no head, and small (XLA's float64 convolutions on the CPU are slow)
DP_SMALL = dict(scales=1, scale_discriminator_params=dict(
    channels=8, max_downsample_channels=16, max_groups=2), periods=[2],
    period_discriminator_params=dict(channels=2, max_downsample_channels=4))
# (generator compute dtype, hybrid, discriminator compute dtype,
# discriminator)
CASES = {"f32": (None, False, None, "small"),
         "hybrid": ("bfloat16", True, None, "small"),
         "f32_head": (None, False, None, "head"),
         "hybrid_disc_bf16": ("bfloat16", True, "bfloat16", "head")}
DISCRIMINATORS = {"head": DP, "small": DP_SMALL}


def _batch(dtype=np.float32):
    rng = np.random.default_rng(0)
    return {"x": (rng.standard_normal((2, 50, 13)).astype(dtype),),
            "y": (0.1 * rng.standard_normal((2, 800, 1))).astype(dtype),
            "ar": (0.1 * rng.standard_normal((2, 64, 1))).astype(dtype)}


def _config(case, remat=False):
    gdt, hybrid, ddt, disc = CASES[case]
    gp = GP if gdt is None else dict(GP, compute_dtype=gdt,
                                      hybrid_precision=hybrid)
    dp = DISCRIMINATORS[disc]
    dp = dp if ddt is None else dict(dp, compute_dtype=ddt)
    return dict(CONFIG, generator_params=gp, discriminator_params=dp,
                use_remat=remat)


@functools.cache
def _generator_params():
    gen = jax_models.build_model("HiFiGANGenerator", GP)
    b = _batch()
    return jax.device_get(_jit(gen.init)(jax.random.PRNGKey(0), b["x"][0],
                                         ar=b["ar"])["params"])


@functools.cache
def _init(disc_name):
    disc = jax_models.build_model(CONFIG["discriminator_type"],
                                  DISCRIMINATORS[disc_name])
    key = jax.random.PRNGKey(0)
    params_d = _jit(disc.init)({"params": key, "window": key},
                               _batch()["y"])["params"]
    return _generator_params(), jax.device_get(params_d)


def _jax_dtype(name):
    return None if name is None else jnp.bfloat16


def _grads(before, after):
    return {k: (before[k] - after[k]) / LR for k in before}


@functools.cache
def _jax_run(case, remat=False, f64=False):
    """JAX's metrics and the generator's and discriminator's gradients
    (in the port's keys) of one SGD step."""
    config = _config(case, remat)
    gp = {k: _jax_dtype(v) if k == "compute_dtype" else v
          for k, v in config["generator_params"].items()}
    dp = {k: _jax_dtype(v) if k == "compute_dtype" else v
          for k, v in config["discriminator_params"].items()}
    gen = jax_models.build_model("HiFiGANGenerator", gp)
    disc = jax_models.build_model(config["discriminator_type"], dp)
    pg, pd = _init(CASES[case][3])
    dtype = np.float64 if f64 else np.float32
    with jax.enable_x64(f64):
        cast = functools.partial(jax.tree.map,
                                 lambda a: jnp.asarray(a, dtype))
        pg, pd = cast(pg), cast(pd)
        tx = jax_optimizer("SGD", {"lr": LR})
        state = jgan.GANTrainState(params_g=pg, params_d=pd,
                                   opt_g=tx.init(pg), opt_d=tx.init(pd),
                                   steps=jnp.asarray(1, jnp.int32))
        step = _jit(jgan.make_train_step(gen, disc,
                                         jgan.GANCriterion(config), config,
                                         tx, tx))
        new, metrics = step(state, _batch(dtype), jax.random.PRNGKey(2),
                            jnp.asarray(LR, dtype), jnp.asarray(LR, dtype))
        new, metrics = jax.device_get((new, metrics))
    sd = weights.jax_params_to_state_dict
    dp = DISCRIMINATORS[CASES[case][3]]

    def dsd(params):
        return weights.jax_msmpd_to_state_dict(params, dp)

    return ({k: float(v) for k, v in metrics.items()},
            _grads(sd(pg, GP), sd(new.params_g, GP)),
            _grads(dsd(pd), dsd(new.params_d)))


def _port_state(case, remat=False, dtype=torch.float32):
    config = _config(case, remat)
    pg, pd = _init(CASES[case][3])
    generator = build_model("HiFiGANGenerator", config["generator_params"])
    generator.load_state_dict(weights.jax_params_to_state_dict(pg, GP))
    discriminator = build_model(config["discriminator_type"],
                                config["discriminator_params"])
    discriminator.load_state_dict(weights.jax_msmpd_to_state_dict(
        pd, DISCRIMINATORS[CASES[case][3]]))
    generator.to(dtype)
    discriminator.to(dtype)
    return config, gan.GANTrainState(
        generator=generator, discriminator=discriminator,
        opt_g=build_optimizer("SGD", {}, -1, generator.parameters()),
        opt_d=build_optimizer("SGD", {}, -1, discriminator.parameters()),
        steps=1)


def _port_run(case, remat=False, dtype=torch.float32):
    config, state = _port_state(case, remat, dtype)
    g0, d0 = ({k: v.clone() for k, v in m.state_dict().items()}
              for m in (state.generator, state.discriminator))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    batch = jax.tree.map(torch.from_numpy, _batch(np_dtype))
    metrics = gan.make_train_step(gan.GANCriterion(config), config)(
        state, batch, LR, LR)
    for p in (*state.generator.parameters(),
              *state.discriminator.parameters()):
        assert p.dtype == dtype
    return ({k: float(v) for k, v in metrics.items()},
            _grads(g0, state.generator.state_dict()),
            _grads(d0, state.discriminator.state_dict()))


def _pooled_gap(got, want):
    gaps = [(got[k].double() - want[k].double()).norm().item() for k in want]
    norms = [want[k].double().norm().item() for k in want]
    return np.linalg.norm(gaps) / np.linalg.norm(norms)


@pytest.mark.parametrize("case", ["hybrid", "hybrid_disc_bf16"])
def test_bf16_step_matches_jax(case):
    metrics, gen_grads, disc_grads = _port_run(case)
    want = _jax_run(case)
    assert sorted(metrics) == sorted(want[0])
    for key, value in want[0].items():
        np.testing.assert_allclose(metrics[key], value, rtol=4e-3,
                                   err_msg=f"{case} {key}")
    # the f32 step's gradients (the port's equal JAX's to ~1e-5 in f32,
    # tests/test_torch_port_train.py)
    f32 = _port_run("f32" if CASES[case][3] == "small" else "f32_head")
    for name, got, jax_bf16, port_f32 in (
            ("generator", gen_grads, want[1], f32[1]),
            ("discriminator", disc_grads, want[2], f32[2])):
        limit = 2 * _pooled_gap(jax_bf16, port_f32)
        gap = _pooled_gap(got, jax_bf16)
        assert 0 < gap <= limit, f"{case} {name}: {gap:.3e} > {limit:.3e}"


def test_hybrid_step_runs_the_stages_in_their_dtypes(monkeypatch):
    """The first stage's pairs take bf16 inputs and the last stage's f32,
    forward and in the regeneration; every parameter's gradient is f32."""
    from articulatory_tpu_torch.layers import residual

    seen = []
    plain = residual.resblock_pair

    def spy(x, *args, **kwargs):
        seen.append((x.dtype, x.shape[-1], torch.is_grad_enabled()))
        return plain(x, *args, **kwargs)

    monkeypatch.setattr(residual, "resblock_pair", spy)
    config, state = _port_state("hybrid")
    gan.make_train_step(gan.GANCriterion(config), config)(
        state, jax.tree.map(torch.from_numpy, _batch()), LR, LR)
    # two pairs a stage; the generator pass (grad) and the regeneration
    stage = [(torch.bfloat16, 16), (torch.bfloat16, 16), (torch.float32, 8),
             (torch.float32, 8)]
    assert seen == ([s + (True,) for s in stage]
                    + [s + (False,) for s in stage])
    criterion = gan.GANCriterion(config)
    batch = jax.tree.map(torch.from_numpy, _batch())
    loss, _ = gan.generator_loss(state, criterion, config, batch)
    grads = torch.autograd.grad(loss, list(state.generator.parameters()))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)


def _count_pairs(monkeypatch):
    """A list that grows by one at every residual pair the generator runs."""
    from articulatory_tpu_torch.layers import residual

    counts, plain = [], residual.resblock_pair

    def counted(*args, **kwargs):
        counts.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(residual, "resblock_pair", counted)
    return counts


def test_remat_step_equals_plain_step_f64():
    want = _port_run("f32", dtype=torch.float64)
    got = _port_run("f32", remat=True, dtype=torch.float64)
    assert sorted(got[0]) == sorted(want[0])
    for key in want[0]:
        np.testing.assert_allclose(got[0][key], want[0][key], rtol=1e-10,
                                   atol=1e-10, err_msg=key)
    for got_g, want_g in zip(got[1:], want[1:]):
        for key in want_g:
            torch.testing.assert_close(got_g[key], want_g[key], rtol=1e-10,
                                       atol=1e-10, msg=key)


def test_remat_step_matches_jax_remat_f64():
    metrics, gen_grads, disc_grads = _port_run("f32", remat=True,
                                               dtype=torch.float64)
    want = _jax_run("f32", remat=True, f64=True)
    for key, value in want[0].items():
        np.testing.assert_allclose(metrics[key], value, rtol=1e-8,
                                   atol=1e-10, err_msg=key)
    for got, theirs in ((gen_grads, want[1]), (disc_grads, want[2])):
        for key, value in theirs.items():
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       rtol=1e-8, atol=1e-8, err_msg=key)


@pytest.mark.parametrize("remat", [False, True])
def test_remat_recomputes_the_generator_forward(monkeypatch, remat):
    """Under remat the generator's forward runs a third time a step (its
    recompute in the backward), beside the loss pass and the regeneration:
    4 pairs a forward."""
    config, state = _port_state("f32", remat)
    counts = _count_pairs(monkeypatch)
    gan.make_train_step(gan.GANCriterion(config), config)(
        state, jax.tree.map(torch.from_numpy, _batch()), LR, LR)
    assert len(counts) == (12 if remat else 8)


def test_remat_skips_a_generator_with_batchnorm():
    """The BiGRU keeps BatchNorm statistics (JAX's mutables): no remat."""
    config = dict(CONFIG, dataset_mode="w2a", use_remat=True,
                  use_stft_loss=False, use_mel_loss=True,
                  use_feat_match_loss=False, generator_type="BiGRU",
                  generator_params=dict(in_channels=1, hidden_size=8,
                                        out_channels=12, dropout=0.0),
                  discriminator_type="ParallelWaveGANDiscriminator",
                  discriminator_params=dict(in_channels=12, layers=3,
                                            conv_channels=4))
    generator = build_model("BiGRU", config["generator_params"])
    discriminator = build_model(config["discriminator_type"],
                                config["discriminator_params"])
    assert gan.has_mutables(generator)
    calls = []
    generator.register_forward_pre_hook(lambda *_: calls.append(1))
    state = gan.GANTrainState(
        generator=generator, discriminator=discriminator,
        opt_g=build_optimizer("SGD", {}, -1, generator.parameters()),
        opt_d=build_optimizer("SGD", {}, -1, discriminator.parameters()),
        steps=1)
    rng = np.random.default_rng(1)
    batch = {"x": (torch.from_numpy(rng.standard_normal((2, 40, 1))
                                    .astype(np.float32)),),
             "y": torch.from_numpy(rng.standard_normal((2, 40, 12))
                                   .astype(np.float32))}
    with unittest.mock.patch.object(gan, "checkpoint") as checkpoint:
        gan.make_train_step(gan.GANCriterion(config), config)(state, batch,
                                                              LR, LR)
    assert not checkpoint.called and len(calls) == 2
