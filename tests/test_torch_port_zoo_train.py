"""One GAN training step per family of the zoo, the port's against the JAX
package's ``make_train_step``, on the same weights and batches.

Families (narrow widths): multi-band HiFi-GAN (4 bands through PQMF, the
subband STFT loss and the mel loss, the MSMPD), MelGAN with its
multi-scale discriminator, Parallel WaveGAN with its discriminator (on
the legacy collater's (noise, aux), and on the aux alone, the
``SpeechCollater``'s batch, whose noise the port's step draws), GBlock,
StyleMelGAN with its random-window PQMF discriminator, and the w2a
inversion models, the BiGRU (AR on) and the Transformer, on the L1
target. Both packages take the
same steps with SGD, so each update is -lr x the gradient: every metric,
and each model's gradient in relative L2 pooled over its tensors, is held
to JAX's (float64 under ``jax.enable_x64``: 1e-8; float32: metrics rtol
1e-3, gradients 1e-3, since a pre-activation at rounding distance from a
LeakyReLU kink takes the other slope in one package). The BiGRU and the
Transformer take two steps (the first with the generator gated off): their
BatchNorm running statistics stay put with the generator off and then
move as JAX's ``batch_stats`` do, and training runs with dropout 0.

Random draws: StyleMelGAN's noise is drawn with JAX and its window offsets
fixed (JAX's ``jax.random.normal`` / ``randint`` patched to hand them out);
the port replays them through a ``RandomDraws`` that returns them by pass.
Parallel WaveGAN on the aux alone is handed, for its generator and
regeneration passes, the noise JAX reads from the (noise, aux) batch.
A Parallel WaveGAN's upsampling Conv2d trains its folded weight in both
packages; JAX's exporter gives it as a weight-norm pair, so its expected
gradient is read from JAX's weight directly."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu import models as jax_models
from articulatory_tpu.ops import pqmf as jax_pqmf
from articulatory_tpu.train import gan as jgan
from articulatory_tpu.train.optimizers import build_optimizer as jax_optimizer
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.train import gan
from articulatory_tpu_torch.train.optimizers import build_optimizer
from articulatory_tpu_torch.utils import weights

torch.set_num_threads(1)

LR = 1e-2
LOSSES = dict(
    sampling_rate=16000, dataset_mode="a2w", use_stft_loss=True,
    stft_loss_params=dict(fft_sizes=[64], hop_sizes=[16], win_lengths=[32]),
    use_mel_loss=False, use_feat_match_loss=True,
    feat_match_loss_params=dict(average_by_discriminators=False,
                                average_by_layers=False,
                                include_final_outputs=False),
    generator_adv_loss_params=dict(average_by_discriminators=False),
    discriminator_adv_loss_params=dict(average_by_discriminators=False),
    lambda_aux=45.0, lambda_adv=1.0, lambda_feat_match=2.0,
    generator_train_start_steps=0, discriminator_train_start_steps=0)
def _msmpd_small(in_channels):
    return dict(scales=1, scale_discriminator_params=dict(
        in_channels=in_channels, channels=8, max_downsample_channels=16,
        max_groups=2),
        periods=[2], period_discriminator_params=dict(
            in_channels=in_channels, channels=2, max_downsample_channels=4))


W2A = dict(LOSSES, dataset_mode="w2a", use_stft_loss=False, use_mel_loss=True,
           generator_train_start_steps=1)


@dataclasses.dataclass
class Family:
    gen_type: str
    gp: dict
    disc_type: str
    dp: dict
    config: dict
    batch: dict  # numpy
    steps: tuple = (1,)
    noise: dict | None = None  # StyleMelGAN: z per pass
    windows: dict | None = None  # StyleMelGAN: offsets per pass
    # PWG: the port's batch drops x[0], the noise, which its step draws
    port_aux_only: bool = False


def _families():
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return rng.standard_normal(shape) * scale

    hop16 = dict(hop_size=16)
    style_windows = {"generator_windows": [3, 100, 17, 60],
                     "real_windows": [0, 1, 90, 63],
                     "fake_windows": [119, 111, 95, 0]}
    fams = {
        "multiband": Family(
            "HiFiGANGenerator",
            dict(in_channels=13, out_channels=4, channels=16, kernel_size=7,
                 upsample_scales=[5, 2, 2], upsample_kernel_sizes=[10, 4, 4],
                 resblock_kernel_sizes=[3, 5],
                 resblock_dilations=[[1, 3], [1, 3]]),
            "HiFiGANMultiScaleMultiPeriodDiscriminator", _msmpd_small(1),
            dict(LOSSES, hop_size=80, pqmf=True, use_subband_stft_loss=True,
                 stft_loss_params=dict(fft_sizes=[128], hop_sizes=[32],
                                       win_lengths=[64]),
                 subband_stft_loss_params=dict(fft_sizes=[32], hop_sizes=[8],
                                               win_lengths=[16]),
                 use_mel_loss=True, mel_loss_params=dict(
                     fs=16000, fft_size=256, hop_size=64, win_length=None,
                     window="hann", num_mels=20, fmin=0, fmax=8000,
                     log_base=None)),
            {"x": (normal(2, 10, 13),), "y": normal(2, 800, 1, scale=0.3)}),
        "melgan": Family(
            "MelGANGenerator", dict(in_channels=13, channels=32,
                                    upsample_scales=[4, 4], stacks=2),
            "MelGANMultiScaleDiscriminator",
            dict(scales=2, channels=8, max_downsample_channels=32,
                 downsample_scales=[2, 2]),
            dict(LOSSES, **hop16),
            {"x": (normal(2, 30, 13),), "y": normal(2, 480, 1, scale=0.3)}),
        "pwg": Family(
            "ParallelWaveGANGenerator",
            dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
                 skip_channels=8, aux_channels=13, aux_context_window=2,
                 upsample_params={"upsample_scales": [4, 4]}),
            "ParallelWaveGANDiscriminator", dict(layers=4, conv_channels=8),
            dict(LOSSES, use_feat_match_loss=False, **hop16),
            {"x": (normal(2, 160, 1), normal(2, 14, 13)),
             "y": normal(2, 160, 1, scale=0.3)}),
        "gblock": Family(
            "GBlockGenerator", dict(in_channels=13, channels=16,
                                    g_scales=[4, 4], g_kernel_sizes=[9, 9]),
            "HiFiGANMultiScaleMultiPeriodDiscriminator", _msmpd_small(1),
            dict(LOSSES, **hop16),
            {"x": (normal(2, 30, 13),), "y": normal(2, 480, 1, scale=0.3)}),
        "style_melgan": Family(
            "StyleMelGANGenerator",
            dict(in_channels=8, aux_channels=10, channels=16,
                 noise_upsample_scales=[4, 4], upsample_scales=[2, 2, 2]),
            "StyleMelGANDiscriminator",
            dict(repeats=1, window_sizes=[8, 16, 32, 64],
                 discriminator_params=dict(
                out_channels=1, kernel_sizes=[5, 3], channels=8,
                max_downsample_channels=32, bias=True,
                downsample_scales=[2, 1], nonlinear_activation="LeakyReLU",
                nonlinear_activation_params={"negative_slope": 0.2},
                pad="ReflectionPad1d", pad_params={})),
            dict(LOSSES, use_feat_match_loss=False, **hop16),
            {"x": (normal(2, 16, 10),), "y": normal(2, 128, 1, scale=0.3)},
            noise={"generator": normal(2, 1, 8),
                   "regeneration": normal(2, 1, 8)},
            windows=style_windows),
        "bigru": Family(
            "BiGRU", dict(in_channels=5 + 8, hidden_size=8, out_channels=4,
                          dropout=0.0, use_ar=True, ar_input=64, ar_hidden=8,
                          ar_output=8),
            "HiFiGANMultiScaleMultiPeriodDiscriminator", _msmpd_small(4),
            dict(W2A, hop_size=1),
            {"x": (normal(2, 12, 5),), "y": normal(2, 12, 4),
             "ar": normal(2, 16, 4)}, steps=(1, 2)),
        "transformer": Family(
            "Transformer", dict(in_channels=5, out_channels=4, hidden_dim=16,
                                elayers=1, dropout=0.0),
            "HiFiGANMultiScaleMultiPeriodDiscriminator", _msmpd_small(4),
            dict(W2A, hop_size=1),
            {"x": (normal(2, 12, 5),), "y": normal(2, 12, 4)},
            steps=(1, 2)),
    }
    fams["pwg_aux"] = dataclasses.replace(fams["pwg"], port_aux_only=True)
    return fams


FAMILIES = _families()


def _config(fam):
    return dict(fam.config, generator_type=fam.gen_type,
                generator_params=fam.gp, discriminator_type=fam.disc_type,
                discriminator_params=fam.dp)


@functools.cache
def _init(name):
    fam = FAMILIES[name]
    gen = jax_models.build_model(fam.gen_type, fam.gp)
    disc = jax_models.build_model(fam.disc_type, fam.dp)
    x = [jnp.asarray(a, jnp.float32) for a in fam.batch["x"]]
    key = jax.random.PRNGKey(0)
    kwargs = {}
    if "ar" in fam.batch:
        kwargs["ar"] = jnp.asarray(fam.batch["ar"], jnp.float32)
    if fam.noise is not None:
        x = x + [jnp.asarray(fam.noise["generator"], jnp.float32)]
    vg = jax.jit(functools.partial(gen.init, **kwargs))(
        {"params": key, "dropout": key}, *x)
    y = jnp.asarray(fam.batch["y"], jnp.float32)
    if "ar" in fam.batch:
        y = jnp.concatenate([kwargs["ar"], y], axis=1)
    vd = jax.jit(disc.init)({"params": key, "window": key}, y)
    vg = jax.device_get(vg)
    return (gen, disc, vg["params"],
            {k: v for k, v in vg.items() if k != "params"},
            jax.device_get(vd["params"]))


def _np(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _patch_draws(monkeypatch, fam, np_dtype):
    """JAX's noise and window draws -> the family's fixed ones, in the
    order the step makes them; PQMF filters in the run's dtype (the JAX
    package keeps them float32, which its float64 convs refuse)."""
    filters = jax_pqmf.pqmf_filterbanks
    monkeypatch.setattr(jax_pqmf, "pqmf_filterbanks", lambda *a: tuple(
        h.astype(np_dtype) for h in filters(*a)))
    if fam.noise is not None:
        noise = [fam.noise["generator"], fam.noise["regeneration"]]
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None:
                            jnp.asarray(noise.pop(0), dtype))
    if fam.windows is not None:
        offsets = [o for tag in ("generator_windows", "real_windows",
                                 "fake_windows") for o in fam.windows[tag]]
        monkeypatch.setattr(jax.random, "randint",
                            lambda key, shape, lo, hi, *a, **k:
                            jnp.asarray(offsets.pop(0), jnp.int32))


@functools.cache
def _jax_run(name, dtype):
    fam = FAMILIES[name]
    gen, disc, pg, mg, pd = _init(name)
    np_dtype = _np(dtype)
    config = _config(fam)
    with jax.enable_x64(dtype == torch.float64), \
            pytest.MonkeyPatch.context() as m:
        _patch_draws(m, fam, np_dtype)
        cast = functools.partial(jax.tree.map,
                                 lambda a: jnp.asarray(a, np_dtype)
                                 if np.issubdtype(np.asarray(a).dtype,
                                                  np.floating) else a)
        tx = jax_optimizer("SGD", {"lr": LR})
        pg, pd, mg = cast(pg), cast(pd), cast(mg)
        state = jgan.GANTrainState(
            params_g=pg, params_d=pd, opt_g=tx.init(pg), opt_d=tx.init(pd),
            steps=jnp.asarray(fam.steps[0], jnp.int32), mutables_g=mg)
        step = jax.jit(jgan.make_train_step(gen, disc,
                                            jgan.GANCriterion(config), config,
                                            tx, tx))
        batch = {k: tuple(cast(v)) if isinstance(v, tuple) else cast(v)
                 for k, v in fam.batch.items()}
        outs = [jax.device_get((state.params_g, state.mutables_g,
                                state.params_d))]
        for _ in fam.steps:
            state, metrics = step(state, batch, jax.random.PRNGKey(2),
                                  jnp.asarray(LR, np_dtype),
                                  jnp.asarray(LR, np_dtype))
            outs.append(jax.device_get((state.params_g, state.mutables_g,
                                        state.params_d, metrics)))
    return outs


class _Replay(gan.RandomDraws):
    def __init__(self, noise, windows):
        super().__init__(0)
        self.noise, self.windows = noise, windows

    def normal(self, shape, like, tag):
        z = torch.tensor(self.noise[tag], dtype=like.dtype)
        assert tuple(z.shape) == tuple(shape)
        return z

    def offsets(self, bounds, tag):
        return list(self.windows[tag])


def _gen_sd(fam, params, mutables):
    return weights.generator_to_state_dict(fam.gen_type, params, mutables,
                                           fam.gp)


def _port_run(name, dtype):
    fam = FAMILIES[name]
    _, _, pg, mg, pd = _init(name)
    np_dtype = _np(dtype)
    cast = functools.partial(jax.tree.map, lambda a: np.asarray(a, np_dtype))
    generator = build_model(fam.gen_type, fam.gp).to(dtype)
    generator.load_state_dict(_gen_sd(fam, cast(pg), cast(mg)))
    discriminator = build_model(fam.disc_type, fam.dp).to(dtype)
    discriminator.load_state_dict(weights.discriminator_to_state_dict(
        fam.disc_type, cast(pd), fam.dp))
    batch = {k: tuple(torch.tensor(a, dtype=dtype) for a in v)
             if isinstance(v, tuple) else torch.tensor(v, dtype=dtype)
             for k, v in fam.batch.items()}
    noise = fam.noise
    if fam.port_aux_only:
        z = fam.batch["x"][0]
        noise = {"generator": z, "regeneration": z}
        batch["x"] = batch["x"][1:]
    state = gan.GANTrainState(
        generator=generator, discriminator=discriminator,
        opt_g=build_optimizer("SGD", {}, -1, generator.parameters()),
        opt_d=build_optimizer("SGD", {}, -1, discriminator.parameters()),
        steps=fam.steps[0], draws=_Replay(noise, fam.windows))
    config = _config(fam)
    step = gan.make_train_step(gan.GANCriterion(config), config)

    def snapshot():
        return ({k: v.clone() for k, v in generator.state_dict().items()},
                {k: v.clone() for k, v in discriminator.state_dict().items()})

    outs = [snapshot()]
    for _ in fam.steps:
        metrics = step(state, batch, LR, LR)
        outs.append((*snapshot(), {k: float(v) for k, v in metrics.items()}))
    return outs


def _expected_grads(fam, before, after, disc):
    """JAX's gradients ((before - after) / lr) in the port's keys."""
    convert = ((lambda p: weights.discriminator_to_state_dict(
        fam.disc_type, p, fam.dp)) if disc else
        (lambda p: _gen_sd(fam, p, before[1])))
    b, a = convert(before[0]), convert(after[0])
    grads = {k: (b[k] - a[k]) / LR for k in b}
    if not disc and fam.gen_type == "ParallelWaveGANGenerator":
        ups = before[0]["upsample_net"]["upsample"]
        ups_after = after[0]["upsample_net"]["upsample"]
        for i in range(len(fam.gp["upsample_params"]["upsample_scales"])):
            w = ups[f"conv_{i}_w"] - ups_after[f"conv_{i}_w"]
            grads[f"upsample_net.upsample.up_layers.{1 + 2 * i}.weight"] = \
                torch.tensor(np.transpose(w, (3, 2, 0, 1))) / LR
    return grads


@pytest.mark.parametrize("name", sorted(FAMILIES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_train_step_matches_jax(name, dtype):
    fam = FAMILIES[name]
    f64 = dtype == torch.float64
    # the aux-only PWG case is held to JAX's (noise, aux) run
    want = _jax_run(name.removesuffix("_aux"), dtype)
    got = _port_run(name, dtype)
    gen_params = {k for k, _ in build_model(fam.gen_type, fam.gp
                                            ).named_parameters()}
    disc_params = {k for k, _ in build_model(fam.disc_type, fam.dp
                                             ).named_parameters()}
    for i, step in enumerate(fam.steps):
        g_before, d_before = got[i][:2]
        g_after, d_after, metrics = got[i + 1]
        w_before, w_after = want[i], want[i + 1]
        jax_metrics = {k: float(v) for k, v in w_after[3].items()}
        assert sorted(metrics) == sorted(jax_metrics)
        for key, value in jax_metrics.items():
            np.testing.assert_allclose(metrics[key], value,
                                       rtol=1e-8 if f64 else 1e-3,
                                       atol=1e-10 if f64 else 1e-6,
                                       err_msg=f"{name} step {step} {key}")
        for disc, before, after, keys, jb, ja in (
                (False, g_before, g_after, gen_params,
                 (w_before[0], w_before[1]), (w_after[0], w_after[1])),
                (True, d_before, d_after, disc_params,
                 (w_before[2],), (w_after[2],))):
            expected = _expected_grads(fam, jb, ja, disc)
            gaps, norms = [], []
            for key in keys:
                ours = (before[key] - after[key]) / LR
                gaps.append((ours - expected[key].to(ours.dtype)).norm().item())
                norms.append(expected[key].norm().item())
            pooled = np.linalg.norm(gaps) / max(np.linalg.norm(norms), 1e-30)
            assert pooled <= (1e-8 if f64 else 1e-3), \
                f"{name} step {step} {'disc' if disc else 'gen'}: {pooled}"
        # BatchNorm statistics: put with the generator off, JAX's after
        stats = [k for k in g_after if "running" in k]
        if stats:
            gen_on = step > fam.config["generator_train_start_steps"]
            want_sd = _gen_sd(fam, w_after[0], w_after[1])
            for key in stats:
                assert gen_on != torch.equal(g_after[key], g_before[key]), key
                np.testing.assert_allclose(
                    g_after[key].numpy(), want_sd[key].numpy(),
                    rtol=1e-8 if f64 else 1e-4, atol=1e-10 if f64 else 1e-6,
                    err_msg=f"{name} step {step} {key}")


def test_fused_disc_passes_refused_for_random_windows():
    config = dict(_config(FAMILIES["style_melgan"]), fuse_disc_passes=True)
    with pytest.raises(ValueError, match="fuse_disc_passes"):
        gan.make_train_step(gan.GANCriterion(config), config)


TRAIN_KEYS = dict(
    format="npy", batch_size=2, num_workers=0, allow_cache=True,
    generator_optimizer_type="Adam",
    generator_optimizer_params=dict(lr=1e-4, betas=[0.5, 0.9]),
    discriminator_optimizer_type="Adam",
    discriminator_optimizer_params=dict(lr=1e-4, betas=[0.5, 0.9]),
    generator_scheduler_type="MultiStepLR",
    generator_scheduler_params=dict(gamma=0.5, milestones=[10]),
    discriminator_scheduler_type="MultiStepLR",
    discriminator_scheduler_params=dict(gamma=0.5, milestones=[10]),
    train_max_steps=2, save_interval_steps=2, eval_interval_steps=2,
    log_interval_steps=100)
# (family, hop, batch_max_steps, utterance frames, input width, output
# width): a2w families read 1-D waves, the w2a ones 200 Hz features in the
# audio stream (hop 1: one output frame a row); a2m reads mels (the
# output) from the dump and articulatory features (the input) through
# feats.scp, frame for frame
CLI = {"multiband": (80, 800, 30, 13, None),
       "pwg": (16, 160, 30, 13, None),
       "style_melgan": (8, 128, 40, 10, None),
       "bigru": (1, 12, 60, 5, 4),
       "transformer": (1, 12, 60, 5, 4),
       "transformer_a2m": (1, 12, 60, 5, 4)}


def _dump(root, frames, in_width, out_width, hop, a2m=False):
    rng = np.random.default_rng(1)
    for stage in ("tr", "dev"):
        dump, data = root / "dump" / stage / "norm", root / "data" / stage
        dump.mkdir(parents=True)
        data.mkdir(parents=True)
        lines = []
        for i in range(3):
            n = frames + 7 * i
            if out_width is None:  # a2w: a wave, features through feats.scp
                stream = 0.3 * rng.standard_normal(n * hop)
                art = rng.standard_normal((n, in_width))
            else:  # w2a: features in the audio stream, EMA the target
                stream = rng.standard_normal((n, in_width))
                art = rng.standard_normal((n, out_width))
            if a2m:  # the mel in the dump, the input through feats.scp
                stream, art = art, stream
            np.save(dump / f"u{i}-wave.npy", stream.astype(np.float32))
            np.save(dump / f"u{i}-feats.npy", (stream if a2m else art
                                               ).astype(np.float32))
            np.save(data / f"u{i}.npy", art.astype(np.float32))
            lines.append(f"u{i} {data / f'u{i}.npy'}\n")
        (data / "feats.scp").write_text("".join(lines))


@pytest.mark.parametrize("name", sorted(CLI))
def test_train_and_decode_cli(name, tmp_path):
    from articulatory_tpu_torch.bin import decode as decode_cli
    from articulatory_tpu_torch.bin import train as train_cli

    a2m = name.endswith("_a2m")
    fam = FAMILIES[name.removesuffix("_a2m")]
    hop, steps, frames, in_width, out_width = CLI[name]
    _dump(tmp_path, frames, in_width, out_width, hop, a2m)
    config = dict(_config(fam), **TRAIN_KEYS, hop_size=hop,
                  batch_max_steps=steps,
                  sampling_rate=16000 if out_width is None else 200)
    if a2m:
        config["dataset_mode"] = "a2m"
    trainer = train_cli.train(
        config, train_dumpdir=str(tmp_path / "dump/tr/norm"),
        dev_dumpdir=str(tmp_path / "dump/dev/norm"),
        outdir=str(tmp_path / "exp"), data_root=str(tmp_path / "data"),
        device="cpu")
    assert trainer.steps == 2
    losses = {k: float(v) for k, v in trainer.total_train_loss.items()}
    assert losses and all(np.isfinite(v) for v in losses.values())
    out = tmp_path / "out"
    # a2m decodes the articulatory features of a feats.scp (a dump
    # directory holds the mels)
    source = (dict(feats_scp=str(tmp_path / "data/dev/feats.scp")) if a2m
              else dict(dumpdir=str(tmp_path / "dump/dev/norm")))
    result = decode_cli.decode(config, str(tmp_path / "exp" /
                                           "checkpoint-2steps.ckpt"),
                               str(out), device="cpu", **source)
    assert result["utterances"] == 3
    for i in range(3):
        n = frames + 7 * i
        if out_width is None:
            from articulatory_tpu_torch.utils.io import read_wav
            wav, sr = read_wav(str(out / f"u{i}_gen.wav"))
            assert sr == 16000 and wav.shape == (n * hop,)
        else:
            # hop 1: the AR decode keeps a ragged tail (shorter than a hop
            # is none)
            y = np.load(out / f"u{i}_gen.npy")
            assert y.shape == (n, out_width) and np.isfinite(y).all()


def test_w2a_collater_matches_jax():
    from articulatory_tpu.data.collate import SpeechCollater as JaxCollater
    from articulatory_tpu_torch.data.collate import SpeechCollater

    rng = np.random.default_rng(2)
    items = [{"audio": rng.standard_normal(40 + 9 * i).astype(np.float32),
              "art": rng.standard_normal((40 + 9 * i, 4)).astype(np.float32)}
             for i in range(3)]
    config = {"generator_params": {"use_ar": True, "ar_input": 32,
                                   "out_channels": 4}}
    want = JaxCollater(12, 1, dataset_mode="w2a", config=config,
                       rng=np.random.default_rng(3))(items)
    got = SpeechCollater(12, 1, dataset_mode="w2a", config=config,
                         rng=np.random.default_rng(3))(items)
    for key in ("x", "y", "ar"):
        for g, w in zip(np.atleast_1d(got[key]) if key != "x" else got[key],
                        np.atleast_1d(want[key]) if key != "x"
                        else want[key]):
            np.testing.assert_array_equal(g, w)
    assert got["x"][0].shape == (3, 12, 1) and got["ar"].shape == (3, 8, 4)
    # frame-rate features in the audio stream stay (B, T, F)
    for d in items:
        d["audio"] = np.stack([d["audio"]] * 5, axis=1)
    got = SpeechCollater(12, 1, dataset_mode="w2a", config=config,
                         rng=np.random.default_rng(3))(items)
    assert got["x"][0].shape == (3, 12, 5)


def _mel_art_dump(root, fmt):
    """Mels (6 bins) in a dump directory, articulatory features (5
    channels) through feats.scp; each utterance's art 3 frames longer or
    shorter than its mel, so the dataset cuts both to the shorter."""
    from articulatory_tpu.utils.io import write_hdf5

    rng = np.random.default_rng(4)
    dump, data = root / "dump" / "tr" / "norm", root / "data" / "tr"
    dump.mkdir(parents=True)
    data.mkdir(parents=True)
    lines = []
    for i in range(3):
        n = 30 + 5 * i
        mel = rng.standard_normal((n, 6)).astype(np.float32)
        art = rng.standard_normal((n + (3 if i % 2 else -3), 5)
                                  ).astype(np.float32)
        if fmt == "hdf5":
            write_hdf5(str(dump / f"u{i}.h5"), "feats", mel)
        else:
            np.save(dump / f"u{i}-feats.npy", mel)
        np.save(data / f"u{i}.npy", art)
        lines.append(f"u{i} {data / f'u{i}.npy'}\n")
    (data / "feats.scp").write_text("".join(lines))
    return str(dump), str(root / "data")


@pytest.mark.parametrize("mode", ["a2m", "m2a"])
def test_mel_art_dataset_and_collater_match_jax(mode, tmp_path):
    from articulatory_tpu.data.collate import CollaterMelArt as JaxCollater
    from articulatory_tpu.data.datasets import MelArtDataset as JaxDataset
    from articulatory_tpu.data.transforms import get_transform as jax_tf
    from articulatory_tpu_torch.data.collate import CollaterMelArt
    from articulatory_tpu_torch.data.datasets import MelArtDataset
    from articulatory_tpu_torch.data.transforms import get_transform

    dump, data_root = _mel_art_dump(tmp_path / "h5", "hdf5")
    want = JaxDataset(dump, transform=jax_tf("10*f0"), data_root=data_root)
    got = MelArtDataset(dump, transform=get_transform("10*f0"),
                        data_root=data_root)
    assert len(got) == len(want) == 3
    for i in range(3):
        (mel, art), (jmel, jart) = got[i], want[i]
        np.testing.assert_array_equal(mel, jmel)
        np.testing.assert_array_equal(art, jart)
        assert len(mel) == len(art) == 30 + 5 * i - (0 if i % 2 else 3)
    # an npy dump (<utt>-feats.npy) pairs by utterance id: the same items
    dump_npy, root_npy = _mel_art_dump(tmp_path / "npy", "npy")
    npy = MelArtDataset(dump_npy, mel_query="*-feats.npy",
                        mel_load_fn=np.load,
                        transform=get_transform("10*f0"), data_root=root_npy)
    for i in range(3):
        for a, b in zip(npy[i], got[i]):
            np.testing.assert_array_equal(a, b)
    items = [got[i] for i in range(3)]
    # 40 samples at hop 4 = 10 frames, 2 frames of context each side
    batch = CollaterMelArt(40, 4, 2, dataset_mode=mode,
                           rng=np.random.default_rng(5))(items)
    jbatch = JaxCollater(40, 4, 2, dataset_mode=mode,
                         rng=np.random.default_rng(5))(
                             [want[i] for i in range(3)])
    np.testing.assert_array_equal(batch["y"], jbatch["y"])
    assert len(batch["x"]) == len(jbatch["x"]) == 1
    np.testing.assert_array_equal(batch["x"][0], jbatch["x"][0])
    x_width, y_width = (6, 5) if mode == "m2a" else (5, 6)
    assert batch["x"][0].shape == (3, 14, x_width)
    assert batch["y"].shape == (3, 14, y_width)
    with pytest.raises(NotImplementedError):
        CollaterMelArt(40, 4, 2, ar_len=8)
