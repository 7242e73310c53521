"""One GAN training step of the conditioned and chained generators, the
port's ``train/gan.py`` against the JAX package's ``make_train_step``, on
the same weights and batches, with the JAX tests' configurations and
widths:

- the phoneme loss (``tests/test_ph_loss_training.py``: a HiFi-GAN with
  the phoneme head, ``lambda_ph`` 0.5, the STFT loss, the MSMPD; 16
  channels where that test has 32);
- PCD (``tests/test_modes_extra.py``: pitch and periodicity interpolated
  to the window and concatenated to the discriminator's 3-channel input);
- ph2a (``tests/test_modes_extra.py``: a Transformer on phoneme ids with
  the Parallel WaveGAN discriminator; its BatchNorm statistics move as
  JAX's ``batch_stats``);
- the cascade (``tests/test_cascade.py``: a BiGRU into a frozen scale-1
  HiFi-GAN, judged against the input ``x[0]``, dropout 0 for a
  deterministic step, the BiGRU's scan not unrolled, which changes only
  JAX's code): ``generator2`` bit for bit unchanged, the generator
  equal to JAX's after the step;
- and a speaker- and phoneme-conditioned HiFi-GAN (every hook and the
  phoneme head on an AR model), beyond the JAX tests' cases.

Both packages step with SGD, so each update is -lr x the gradient: every
metric, and each model's gradient in relative L2 pooled over its tensors,
is held to JAX's (float64 under ``jax.enable_x64``: 1e-8; float32: metrics
rtol 1e-3, gradients 1e-3, as ``test_torch_port_zoo_train.py``, or twice
JAX's own float32 gradient's distance from its float64 one where that is
larger: two float32 estimates each that far from the exact gradient can be
twice as far apart. The PCD step's mel loss at ``lambda_aux`` 45 reads
3.4e-3 there in JAX itself). The eval step of the phoneme loss and of the
cascade is held to JAX's in float64.
"""

import dataclasses
import functools

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

LR = 1e-2
# the reference's programs compiled at XLA's lowest backend optimisation
# level: they compile in a fraction of the time, and each test holds the
# port to what the compiled program computes
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_llvm_disable_expensive_passes": True})
ADV = dict(generator_adv_loss_params={"average_by_discriminators": False},
           discriminator_adv_loss_params={"average_by_discriminators": False},
           use_feat_match_loss=False, lambda_aux=1.0, lambda_adv=1.0,
           generator_train_start_steps=0, discriminator_train_start_steps=0)


def _msmpd(in_channels=1):
    return dict(scales=1, scale_discriminator_params=dict(
        in_channels=in_channels, channels=8, max_downsample_channels=16,
        max_groups=2), periods=[2], period_discriminator_params=dict(
        in_channels=in_channels, channels=2, max_downsample_channels=4))


@dataclasses.dataclass
class Case:
    gen_type: str
    gp: dict
    disc_type: str
    dp: dict
    config: dict
    batch: dict  # numpy; integer arrays are ids
    gen2_type: str | None = None
    gp2: dict | None = None


def _cases():
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return rng.standard_normal(shape) * scale

    ph_loss = Case(
        "HiFiGANGenerator", dict(
            in_channels=13, channels=16, kernel_size=7,
            upsample_scales=[4, 4], upsample_kernel_sizes=[8, 8],
            resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]],
            use_ph_loss=True, num_ph=5),
        "HiFiGANMultiScaleMultiPeriodDiscriminator", _msmpd(),
        dict(ADV, dataset_mode="a2w", batch_max_steps=800, hop_size=16,
             use_stft_loss=True, stft_loss_params=dict(
                 fft_sizes=[128], hop_sizes=[32], win_lengths=[64]),
             use_mel_loss=False, lambda_ph=0.5,
             generator_adv_loss_params={"average_by_discriminators": True},
             discriminator_adv_loss_params={
                 "average_by_discriminators": True}),
        {"x": (normal(2, 50, 13),), "y": normal(2, 800, 1, scale=0.1),
         "ph": rng.integers(0, 5, (2, 50)).astype(np.int32)})
    pcd = Case(
        "HiFiGANGenerator", dict(
            in_channels=13, channels=16, upsample_scales=[5, 4, 2, 2],
            upsample_kernel_sizes=[10, 8, 4, 4], resblock_kernel_sizes=[3],
            resblock_dilations=[[1]]),
        "HiFiGANMultiScaleMultiPeriodDiscriminator", _msmpd(3),
        dict(ADV, dataset_mode="a2w", batch_max_steps=800, hop_size=80,
             use_pcd=True, use_stft_loss=False, use_mel_loss=True,
             mel_loss_params=dict(fs=16000, fft_size=256, hop_size=80,
                                  num_mels=20, fmin=0, fmax=8000),
             lambda_aux=45.0),
        {"x": (normal(2, 10, 13),), "y": normal(2, 800, 1, scale=0.1),
         "pitch": normal(2, 10, 1), "periodicity": normal(2, 10, 1)})
    ph2a = Case(
        "Transformer", dict(in_channels=8, out_channels=12, elayers=1,
                            hidden_dim=32, dropout=0.0, num_ph=40,
                            ph_emb_size=8),
        "ParallelWaveGANDiscriminator", dict(in_channels=12, layers=3,
                                             conv_channels=8),
        dict(ADV, dataset_mode="ph2a", batch_max_steps=800, hop_size=80,
             use_stft_loss=False, use_mel_loss=True, lambda_adv=0.1),
        {"x": (rng.integers(0, 40, (2, 20)).astype(np.int32),),
         "y": normal(2, 20, 12)})
    cascade = Case(
        "BiGRU", dict(in_channels=1, hidden_size=16, out_channels=12,
                      dropout=0.0, scan_unroll=1),
        "HiFiGANMultiScaleMultiPeriodDiscriminator", _msmpd(),
        dict(ADV, dataset_mode="w2a", batch_max_steps=800, hop_size=80,
             use_stft_loss=False, use_mel_loss=True),
        {"x": (normal(2, 800, 1, scale=0.1),), "y": normal(2, 800, 12)},
        "HiFiGANGenerator", dict(
            in_channels=12, out_channels=1, channels=16,
            upsample_scales=[1], upsample_kernel_sizes=[2],
            resblock_kernel_sizes=[3], resblock_dilations=[[1]]))
    conditioned = Case(
        "HiFiGANGenerator", dict(
            in_channels=13 + 8, channels=16, upsample_scales=[4, 4],
            upsample_kernel_sizes=[8, 8], resblock_kernel_sizes=[3],
            resblock_dilations=[[1, 3]], use_ar=True, ar_input=32,
            ar_hidden=8, ar_output=8, use_spk_id=True, num_spk=3,
            spk_emb_size=4, use_ph=True, num_ph=5, ph_emb_size=3,
            use_ph_loss=True),
        "HiFiGANMultiScaleMultiPeriodDiscriminator", _msmpd(),
        dict(ADV, dataset_mode="a2w", batch_max_steps=160, hop_size=16,
             use_stft_loss=True, stft_loss_params=dict(
                 fft_sizes=[64], hop_sizes=[16], win_lengths=[32]),
             use_mel_loss=False, lambda_ph=0.5),
        {"x": (normal(2, 10, 13),), "y": normal(2, 160, 1, scale=0.1),
         "ar": normal(2, 32, 1, scale=0.1),
         "spk_id": np.array([2, 0], np.int32),
         "ph": rng.integers(0, 5, (2, 10)).astype(np.int32)})
    return {"ph_loss": ph_loss, "pcd": pcd, "ph2a": ph2a, "cascade": cascade,
            "conditioned": conditioned}


CASES = _cases()


def _config(case):
    config = dict(case.config, generator_type=case.gen_type,
                  generator_params=case.gp, discriminator_type=case.disc_type,
                  discriminator_params=case.dp)
    if case.gen2_type is not None:
        config.update(generator2_type=case.gen2_type,
                      generator2_params=case.gp2)
    return config


def _np(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _floats(tree, np_dtype):
    """Float leaves in ``np_dtype``; integer ids as they are."""
    return jax.tree.map(lambda a: np.asarray(a, np_dtype)
                        if np.issubdtype(np.asarray(a).dtype, np.floating)
                        else np.asarray(a), tree)


@functools.cache
def _init(name):
    case = CASES[name]
    gen = jax_models.build_model(case.gen_type, case.gp)
    disc = jax_models.build_model(case.disc_type, case.dp)
    key = jax.random.PRNGKey(0)
    x = [jnp.asarray(a, jnp.float32 if a.dtype.kind == "f" else a.dtype)
         for a in case.batch["x"]]
    kwargs = {k: jnp.asarray(case.batch[k], jnp.float32
                             if case.batch[k].dtype.kind == "f" else None)
              for k in ("ar", "spk_id", "ph")
              if k in case.batch and case.gen_type == "HiFiGANGenerator"}
    gen2 = None
    y = jnp.asarray(case.batch["y"], jnp.float32)
    if case.gen2_type is not None:
        gen2 = jax_models.build_model(case.gen2_type, case.gp2)
        y = x[0]
    if case.config.get("use_pcd"):
        y = jnp.zeros(y.shape[:2] + (3,), jnp.float32)

    def init(x, kwargs, y):  # the models' inits in one program
        vg = gen.init({"params": key, "dropout": key}, *x, **kwargs)
        params_g2 = (None if gen2 is None else
                     gen2.init(key, gen.apply(vg, *x))["params"])
        return vg, disc.init({"params": key, "window": key}, y), params_g2

    vg, vd, params_g2 = jax.device_get(_jit(init)(x, kwargs, y))
    return (gen, disc, gen2, vg["params"],
            {k: v for k, v in vg.items() if k != "params"}, vd["params"],
            params_g2)


@functools.cache
def _jax_run(name, dtype):
    """JAX's step: (params_g, mutables_g, params_d) before and after, the
    metrics, and (float64) the eval step's metrics."""
    case = CASES[name]
    gen, disc, gen2, pg, mg, pd, pg2 = _init(name)
    np_dtype = _np(dtype)
    config = _config(case)
    with jax.enable_x64(dtype == torch.float64):
        cast = functools.partial(jax.tree.map, lambda a: jnp.asarray(
            a, np_dtype) if np.issubdtype(np.asarray(a).dtype, np.floating)
            else jnp.asarray(a))
        tx = jax_optimizer("SGD", {"lr": LR})
        pg, pd, mg = cast(pg), cast(pd), cast(mg)
        pg2 = None if pg2 is None else cast(pg2)
        state = jgan.GANTrainState(
            params_g=pg, params_d=pd, opt_g=tx.init(pg), opt_d=tx.init(pd),
            steps=jnp.asarray(1, jnp.int32), mutables_g=mg, params_g2=pg2)
        criterion = jgan.GANCriterion(config)
        step = _jit(jgan.make_train_step(gen, disc, criterion, config, tx,
                                            tx, gen2=gen2))
        batch = {k: tuple(cast(a) for a in v) if isinstance(v, tuple)
                 else cast(v) for k, v in case.batch.items()}
        before = jax.device_get((state.params_g, state.mutables_g,
                                 state.params_d))
        new, metrics = step(state, batch, jax.random.PRNGKey(2),
                            jnp.asarray(LR, np_dtype),
                            jnp.asarray(LR, np_dtype))
        after = jax.device_get((new.params_g, new.mutables_g, new.params_d,
                                new.params_g2))
        eval_metrics = None
        if dtype == torch.float64 and name in ("ph_loss", "cascade"):
            eval_step = _jit(jgan.make_eval_step(gen, disc, criterion,
                                                    config, gen2=gen2))
            eval_metrics = jax.device_get(eval_step(
                state, batch, jax.random.PRNGKey(3))[0])
    return before, after, jax.device_get(metrics), eval_metrics


def _gen_sd(case, params, mutables, second=False):
    return weights.generator_to_state_dict(
        case.gen2_type if second else case.gen_type, params, mutables,
        case.gp2 if second else case.gp)


def _port_state(name, dtype):
    case = CASES[name]
    _, _, _, pg, mg, pd, pg2 = _init(name)
    np_dtype = _np(dtype)
    generator = build_model(case.gen_type, case.gp).to(dtype)
    generator.load_state_dict(_gen_sd(case, _floats(pg, np_dtype),
                                      _floats(mg, np_dtype)))
    discriminator = build_model(case.disc_type, case.dp).to(dtype)
    discriminator.load_state_dict(weights.discriminator_to_state_dict(
        case.disc_type, _floats(pd, np_dtype), case.dp))
    generator2 = None
    if case.gen2_type is not None:
        generator2 = build_model(case.gen2_type, case.gp2).to(dtype)
        generator2.load_state_dict(_gen_sd(case, _floats(pg2, np_dtype), {},
                                           second=True))
        generator2.requires_grad_(False)
    state = gan.GANTrainState(
        generator=generator, discriminator=discriminator,
        opt_g=build_optimizer("SGD", {}, -1, generator.parameters()),
        opt_d=build_optimizer("SGD", {}, -1, discriminator.parameters()),
        steps=1, generator2=generator2)
    batch = {k: tuple(torch.as_tensor(_floats(a, np_dtype)) for a in v)
             if isinstance(v, tuple) else torch.as_tensor(_floats(v, np_dtype))
             for k, v in case.batch.items()}
    return state, batch


def _pooled_gap(got, want):
    """Relative L2 gap of two gradient dicts, pooled over their tensors."""
    gaps = [(got[k].double() - want[k].double()).norm().item() for k in want]
    norms = [w.norm().item() for w in want.values()]
    return np.linalg.norm(gaps) / max(np.linalg.norm(norms), 1e-30)


def _jax_grads(case, run, keys, disc):
    """JAX's gradients ((before - after) / lr) in the port's keys."""
    before, after = run[0], run[1]
    if disc:
        b, a = (weights.discriminator_to_state_dict(case.disc_type, p[2],
                                                    case.dp)
                for p in (before, after))
    else:
        b, a = (_gen_sd(case, p[0], p[1]) for p in (before, after))
    return {k: (b[k] - a[k]) / LR for k in keys}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_train_step_matches_jax(name, dtype):
    case = CASES[name]
    f64 = dtype == torch.float64
    before, after, jax_metrics, _ = _jax_run(name, dtype)
    state, batch = _port_state(name, dtype)
    config = _config(case)
    g0 = {k: v.clone() for k, v in state.generator.state_dict().items()}
    d0 = {k: v.clone() for k, v in state.discriminator.state_dict().items()}
    g2_0 = (None if state.generator2 is None else
            {k: v.clone() for k, v in state.generator2.state_dict().items()})
    metrics = gan.make_train_step(gan.GANCriterion(config), config)(
        state, batch, LR, LR)
    metrics = {k: float(v) for k, v in metrics.items()}
    want = {k: float(v) for k, v in jax_metrics.items()}
    assert sorted(metrics) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(metrics[key], value,
                                   rtol=1e-8 if f64 else 1e-3,
                                   atol=1e-10 if f64 else 1e-6,
                                   err_msg=f"{name} {key}")
    if case.gp.get("use_ph_loss"):
        assert metrics["train/ph_loss"] > 0
    g1 = state.generator.state_dict()
    d1 = state.discriminator.state_dict()
    jg1 = _gen_sd(case, after[0], after[1])
    gen_params = {k for k, _ in state.generator.named_parameters()}
    for disc, ours0, ours1 in ((False, g0, g1), (True, d0, d1)):
        model = state.discriminator if disc else state.generator
        keys = {k for k, _ in model.named_parameters()}
        want = _jax_grads(case, (before, after), keys, disc)
        gap = _pooled_gap({k: (ours0[k] - ours1[k]) / LR for k in keys}, want)
        limit = 1e-8
        if not f64:  # JAX's own float32 error, against its float64 step
            exact = _jax_grads(case, _jax_run(name, torch.float64), keys,
                               disc)
            limit = max(1e-3, 2 * _pooled_gap(want, exact))
        assert gap <= limit, f"{name} {'disc' if disc else 'gen'}: {gap}"
    # BatchNorm statistics (the Transformer's) as JAX's batch_stats
    for key in (k for k in g1 if "running" in k):
        assert not torch.equal(g1[key], g0[key]), key
        np.testing.assert_allclose(g1[key].numpy(), jg1[key].numpy(),
                                   rtol=1e-8 if f64 else 1e-4,
                                   atol=1e-10 if f64 else 1e-6)
    if state.generator2 is not None:
        # frozen: bit for bit, and no gradient kept on it
        for key, value in state.generator2.state_dict().items():
            assert torch.equal(value, g2_0[key]), key
        assert all(p.grad is None and not p.requires_grad
                   for p in state.generator2.parameters())
        # the trained generator equals JAX's after the step
        for key in gen_params:
            np.testing.assert_allclose(
                g1[key].numpy(), jg1[key].numpy().astype(_np(dtype)),
                rtol=1e-8 if f64 else 1e-4, atol=1e-10 if f64 else 1e-6,
                err_msg=key)
        # and JAX's generator2 did not move either
        jax.tree.map(np.testing.assert_array_equal,
                     _floats(_init(name)[6], _np(dtype)), after[3])


@pytest.mark.parametrize("name", ["ph_loss", "cascade"])
def test_eval_step_matches_jax(name):
    case = CASES[name]
    want = {k: float(v) for k, v in _jax_run(name, torch.float64)[3].items()}
    state, batch = _port_state(name, torch.float64)
    config = _config(case)
    metrics, y_ = gan.make_eval_step(gan.GANCriterion(config), config)(
        state, batch)
    assert sorted(metrics) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(float(metrics[key]), value, rtol=1e-8,
                                   atol=1e-10, err_msg=f"{name} {key}")
    assert state.generator.training and (
        state.generator2 is None or state.generator2.training)


def test_jax_checkpoint_generator2_carries_across(tmp_path):
    """A JAX checkpoint of the cascade (``model.generator2`` beside the
    generator and discriminator, the BiGRU's statistics in ``mutables``)
    restores into the port's state, every tensor as converted, and the
    port's own checkpoint keeps generator2."""
    from articulatory_tpu.utils.checkpoint import (
        save_checkpoint as jax_save,
    )
    from articulatory_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        restore_state,
        save_checkpoint,
    )

    case = CASES["cascade"]
    _, _, _, pg, mg, pd, pg2 = _init("cascade")
    tx = jax_optimizer("SGD", {"lr": LR})
    jax_save(str(tmp_path / "jax.pkl"), jgan.GANTrainState(
        params_g=pg, params_d=pd, opt_g=tx.init(pg), opt_d=tx.init(pd),
        steps=jnp.asarray(3, jnp.int32), mutables_g=mg, params_g2=pg2))
    state, _ = _port_state("cascade", torch.float32)
    for p in (*state.generator.parameters(), *state.generator2.parameters(),
              *state.discriminator.parameters()):
        p.data.zero_()
    restore_state(state, load_checkpoint(str(tmp_path / "jax.pkl")),
                  _config(case), load_only_params=True)
    for model, want in ((state.generator, _gen_sd(case, pg, mg)),
                        (state.generator2, _gen_sd(case, pg2, {}, True))):
        got = model.state_dict()
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key].numpy(), value.numpy(),
                                          err_msg=key)
    save_checkpoint(str(tmp_path / "port.pkl"), state)
    saved = load_checkpoint(str(tmp_path / "port.pkl"))["model"]["generator2"]
    for key, value in state.generator2.state_dict().items():
        assert torch.equal(saved[key], value), key
