"""One GAN training step of the port against the JAX package's
``make_train_step``, on the same weights and batches.

A tiny HiFi-CAR (AR on, channels 16) and a tiny MSMPD (the configs' 128-
channel scale head at stride 4, period 2 over 61 + 800 samples, so the
reflect pad runs) are initialised in JAX and
carried across; both packages take steps 0, 1 and 2 with
``generator_train_start_steps`` 1 and ``discriminator_train_start_steps``
0 (step 0 updates nothing, step 1 the discriminator, step 2 both) on the
e2w losses (mel L1 x 45, LSGAN, feature matching x 2). After every step the
metrics and every generator and discriminator parameter are held against
JAX's. With SGD every update is -lr x the gradient, so the same comparison
holds the generator and discriminator gradients themselves: float64 to 1e-8
elementwise. In float32 the update of each model is held in relative L2,
pooled over its tensors (5e-3) and per tensor (5e-2), and the metrics to
rtol 1e-3: a pre-activation at rounding distance from a LeakyReLU kink
takes the other slope in one of the two packages, and the scale
discriminators' first-layer gradients cancel to a few 1e-3 of their terms,
so single tensors differ by up to a few percent (3.3e-2 seen) while the
pooled update agrees to about 1e-3.
Adam (the config's optimizer) is held in float64 to 1e-8; in float32 its
first update is lr x sign(g) per element, so a gradient at the level of f32
rounding noise flips an element by 2 lr, and the float32 comparison is made
on the gradients instead."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.models.hifigan import (
    HiFiGANGenerator as JaxGenerator,
    HiFiGANMultiScaleMultiPeriodDiscriminator as JaxMSMPD,
)
from articulatory_tpu.train import gan as jgan
from articulatory_tpu.train.optimizers import build_optimizer as jax_optimizer
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.train import gan
from articulatory_tpu_torch.train.optimizers import build_optimizer
from articulatory_tpu_torch.utils.weights import (
    jax_msmpd_to_state_dict,
    jax_params_to_state_dict,
)

torch.set_num_threads(1)

GP = dict(in_channels=13 + 8, out_channels=1, channels=16, kernel_size=7,
          upsample_scales=[5, 4, 2, 2], upsample_kernel_sizes=[10, 8, 4, 4],
          resblock_kernel_sizes=[3, 7], resblock_dilations=[[1, 3], [1, 3]],
          use_additional_convs=True, bias=True,
          nonlinear_activation="LeakyReLU",
          nonlinear_activation_params=dict(negative_slope=0.1),
          use_weight_norm=True, use_ar=True, ar_input=61, ar_hidden=8,
          ar_output=8)
DP = dict(scales=2, scale_downsample_pooling_params=dict(
    kernel_size=4, stride=2, padding=2),
    scale_discriminator_params=dict(
        channels=128, max_downsample_channels=128, max_groups=16,
        downsample_scales=[4, 4, 1]),
    follow_official_norm=True, periods=[2],
    period_discriminator_params=dict(channels=4, max_downsample_channels=8,
                                     downsample_scales=[3, 1]))
CONFIG = dict(
    sampling_rate=16000, hop_size=80, dataset_mode="a2w", batch_max_steps=800,
    generator_type="HiFiGANGenerator", generator_params=GP,
    discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
    discriminator_params=DP, use_stft_loss=False, use_mel_loss=True,
    mel_loss_params=dict(fs=16000, fft_size=256, hop_size=64, win_length=None,
                         window="hann", num_mels=20, fmin=0, fmax=11025,
                         log_base=None),
    generator_adv_loss_params=dict(average_by_discriminators=False),
    discriminator_adv_loss_params=dict(average_by_discriminators=False),
    use_feat_match_loss=True,
    feat_match_loss_params=dict(average_by_discriminators=False,
                                average_by_layers=False,
                                include_final_outputs=False),
    lambda_aux=45.0, lambda_adv=1.0, lambda_feat_match=2.0,
    generator_train_start_steps=1, discriminator_train_start_steps=0)
OPTIMIZERS = {"Adam": (dict(betas=(0.5, 0.9), weight_decay=0.0), 1e-4),
              "SGD": ({}, 1e-2)}


def _tuples(d):
    return {k: _tuples(v) if isinstance(v, dict) else
            tuple(map(tuple, v)) if k == "resblock_dilations" else
            tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _batches():
    rng = np.random.default_rng(0)
    return [{"x": (rng.standard_normal((2, 10, 13)),),
             "y": rng.standard_normal((2, 800, 1)) * 0.3,
             "ar": rng.standard_normal((2, 61, 1)) * 0.3} for _ in range(3)]


@functools.cache
def _init():
    gen, disc = JaxGenerator(**_tuples(GP)), JaxMSMPD(**_tuples(DP))
    params_g = jax.jit(gen.init)(jax.random.PRNGKey(0), jnp.zeros((1, 10, 13)),
                                 ar=jnp.zeros((1, 61, 1)))["params"]
    params_d = jax.jit(disc.init)(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 861, 1)))["params"]
    return gen, disc, jax.device_get(params_g), jax.device_get(params_d)


def _jax_run(opt, np_dtype):
    """JAX's metrics and (generator, discriminator) params after each of
    three steps, as numpy."""
    gen, disc, params_g, params_d = _init()
    opt_params, lr = OPTIMIZERS[opt]
    cast = functools.partial(jax.tree.map, lambda a: jnp.asarray(a, np_dtype))
    tx_g = jax_optimizer(opt, dict(opt_params, lr=lr))
    tx_d = jax_optimizer(opt, dict(opt_params, lr=lr))
    params_g, params_d = cast(params_g), cast(params_d)
    state = jgan.GANTrainState(params_g=params_g, params_d=params_d,
                               opt_g=tx_g.init(params_g),
                               opt_d=tx_d.init(params_d),
                               steps=jnp.asarray(0, jnp.int32))
    step = jax.jit(jgan.make_train_step(gen, disc, jgan.GANCriterion(CONFIG),
                                        CONFIG, tx_g, tx_d))
    out = []
    for batch in _batches():
        batch = {"x": tuple(cast(batch["x"])), "y": cast(batch["y"]),
                 "ar": cast(batch["ar"])}
        state, metrics = step(state, batch, jax.random.PRNGKey(2),
                              jnp.asarray(lr, np_dtype),
                              jnp.asarray(lr, np_dtype))
        out.append(jax.device_get((metrics, state.params_g, state.params_d)))
    return out


def _port_run(opt, dtype):
    _, _, params_g, params_d = _init()
    opt_params, lr = OPTIMIZERS[opt]
    generator = build_model("HiFiGANGenerator", GP)
    generator.load_state_dict(jax_params_to_state_dict(params_g, GP))
    discriminator = build_model("HiFiGANMultiScaleMultiPeriodDiscriminator",
                                DP)
    discriminator.load_state_dict(jax_msmpd_to_state_dict(params_d, DP))
    generator.to(dtype)
    discriminator.to(dtype)
    state = gan.GANTrainState(
        generator=generator, discriminator=discriminator,
        opt_g=build_optimizer(opt, opt_params, -1, generator.parameters()),
        opt_d=build_optimizer(opt, opt_params, -1, discriminator.parameters()))
    step = gan.make_train_step(gan.GANCriterion(CONFIG), CONFIG)
    out = []
    for batch in _batches():
        batch = {"x": (torch.tensor(batch["x"][0], dtype=dtype),),
                 "y": torch.tensor(batch["y"], dtype=dtype),
                 "ar": torch.tensor(batch["ar"], dtype=dtype)}
        metrics = step(state, batch, lr, lr)
        out.append(({k: float(v) for k, v in metrics.items()},
                    {k: v.clone() for k, v in generator.state_dict().items()},
                    {k: v.clone() for k, v in discriminator.state_dict().items()}))
    assert state.steps == 3
    return out


@pytest.mark.parametrize("opt,dtype,rtol,atol", [
    ("Adam", torch.float64, 1e-8, 1e-8),
    ("SGD", torch.float64, 1e-8, 1e-8),
    ("SGD", torch.float32, 1e-3, None)])
def test_train_steps_match_jax(opt, dtype, rtol, atol):
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    with jax.enable_x64(dtype == torch.float64):
        want = _jax_run(opt, np_dtype)
    got = _port_run(opt, dtype)
    _, _, init_g, init_d = _init()
    init = (jax_params_to_state_dict(init_g, GP),
            jax_msmpd_to_state_dict(init_d, DP))
    for step, ((gm, gg, gd), (wm, wg, wd)) in enumerate(zip(got, want)):
        assert sorted(gm) == sorted(wm)
        for key in wm:
            np.testing.assert_allclose(gm[key], float(wm[key]), rtol=rtol,
                                       atol=atol or 0,
                                       err_msg=f"step {step} {key}")
        for ours, theirs, before, moved in (
                (gg, jax_params_to_state_dict(wg, GP), init[0], step >= 2),
                (gd, jax_msmpd_to_state_dict(wd, DP), init[1], step >= 1)):
            gaps, norms = [], []
            for key, value in theirs.items():
                # gating: a model moves only from its first gated step on
                assert moved == (not torch.equal(
                    ours[key], before[key].to(ours[key].dtype))), \
                    f"step {step} {key}"
                if atol is None:  # float32: the update, in relative L2
                    gaps.append(np.linalg.norm(ours[key].numpy()
                                               - value.numpy()))
                    norms.append(np.linalg.norm(value.numpy()
                                                - before[key].numpy()))
                    assert gaps[-1] <= 5e-2 * norms[-1], f"step {step} {key}"
                else:
                    np.testing.assert_allclose(
                        ours[key].numpy(), value.numpy(), rtol=rtol,
                        atol=atol, err_msg=f"step {step} {key}")
            assert np.linalg.norm(gaps) <= 5e-3 * np.linalg.norm(norms)


@pytest.mark.parametrize("name", ["Adam", "AdamW", "RAdam", "NAdam", "SGD",
                                  "RMSprop", "Adagrad", "Adadelta", "Adamax",
                                  "ASGD", "Rprop"])
def test_every_optimizer_name_builds_and_steps(name):
    p = torch.nn.Parameter(torch.ones(3, dtype=torch.float64))
    opt = build_optimizer(name, {"lr": 0.5}, -1, [p])
    p.grad = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    opt.step(0.1)
    assert opt.optimizer.param_groups[0]["lr"] == 0.1
    assert not torch.equal(p.detach(), torch.ones(3, dtype=torch.float64))


@pytest.mark.parametrize("grad_norm", [0.5, 100.0])
def test_grad_norm_clip_matches_optax(grad_norm):
    """SGD at lr 1 after the clip: the update is optax's clipped gradient."""
    import optax

    rng = np.random.default_rng(0)
    grads = [rng.standard_normal((4, 3)), rng.standard_normal(5)]
    want, _ = optax.clip_by_global_norm(grad_norm).update(
        [jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(g.shape, dtype=torch.float64))
              for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.tensor(g)
    build_optimizer("SGD", {}, grad_norm, params).step(1.0)
    for p, w in zip(params, want):
        np.testing.assert_allclose(-p.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-7)


def test_unknown_optimizer_names_raise():
    for name in ("LBFGS", "SparseAdam", "Lion"):
        with pytest.raises(ValueError):
            build_optimizer(name, {}, -1, [torch.nn.Parameter(torch.ones(1))])
