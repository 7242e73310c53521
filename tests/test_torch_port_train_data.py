"""The training data paths the port adds to the JAX package's: m2w (mel to
wave) and the ``window`` and ``pad`` package modes, on the CPU.

- m2w: ``SpeechDataset`` loads the mels (``-feats.npy``, cut to the art's
  frames) and ``SpeechCollater`` windows them with the art frames, x =
  (mel,), with the waveform AR past; datasets and batches equal the JAX
  package's for one ``np.random.Generator`` seed, bit for bit. Then one
  float64 GAN step of a HiFi-GAN on mels (seeded weights in the trees of
  JAX's init, carried across) on that batch against JAX's
  ``make_train_step`` (SGD, so each update is -lr x the gradient): the
  metrics and every parameter to 1e-8.
- ``window`` and ``pad``: batches of a2w, w2a (a raw wave and a feature
  stream) and ph2a items bit-equal to JAX's ``SpeechCollater``, with
  nonzero pad values; an AR past in ``window`` mode is refused, as JAX
  refuses it (the port when the collater is built, JAX at the first
  batch), and so is a mel stream, which JAX's collater does not batch in
  these modes.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu import models as jax_models
from articulatory_tpu.data import collate as jax_collate
from articulatory_tpu.data import datasets as jax_datasets
from articulatory_tpu.train import gan as jgan
from articulatory_tpu.train.optimizers import build_optimizer as jax_optimizer
from articulatory_tpu_torch.data import collate, datasets
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.train import gan
from articulatory_tpu_torch.train.optimizers import build_optimizer
from articulatory_tpu_torch.utils import weights

torch.set_num_threads(1)

HOP, FRAMES, N_MELS, N_ART = 16, 10, 6, 5
LR = 1e-2
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_llvm_disable_expensive_passes": True})
GP = dict(in_channels=N_MELS + 8, channels=16, upsample_scales=[4, 4],
          upsample_kernel_sizes=[8, 8], resblock_kernel_sizes=[3],
          resblock_dilations=[[1]], use_ar=True, ar_input=32, ar_hidden=8,
          ar_output=8)
DP = dict(scales=1, scale_discriminator_params=dict(
    channels=8, max_downsample_channels=16, max_groups=2), periods=[2],
    period_discriminator_params=dict(channels=2, max_downsample_channels=4))
CONFIG = dict(
    dataset_mode="m2w", batch_max_steps=FRAMES * HOP, hop_size=HOP,
    use_stft_loss=False, use_mel_loss=True, mel_loss_params=dict(
        fs=16000, fft_size=64, hop_size=16, win_length=None, window="hann",
        num_mels=10, fmin=0, fmax=8000, log_base=None),
    generator_adv_loss_params=dict(average_by_discriminators=False),
    discriminator_adv_loss_params=dict(average_by_discriminators=False),
    use_feat_match_loss=True, lambda_aux=45.0, lambda_adv=1.0,
    lambda_feat_match=2.0, generator_train_start_steps=0,
    discriminator_train_start_steps=0,
    generator_type="HiFiGANGenerator", generator_params=GP,
    discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
    discriminator_params=DP)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """An npy dump of 4 utterances: waves, mels (2 frames over the art's)
    in ``-feats.npy`` and art through ``data/tr/feats.scp``."""
    root = tmp_path_factory.mktemp("m2w")
    rng = np.random.default_rng(0)
    dump, data = root / "dump" / "tr" / "norm", root / "data" / "tr"
    dump.mkdir(parents=True)
    data.mkdir(parents=True)
    lines = []
    for i in range(4):
        n = 30 + 7 * i
        np.save(dump / f"u{i}-wave.npy",
                (0.3 * rng.standard_normal(n * HOP + 3)).astype(np.float32))
        np.save(dump / f"u{i}-feats.npy",
                rng.standard_normal((n + 2, N_MELS)).astype(np.float32))
        np.save(data / f"u{i}.npy",
                rng.standard_normal((n, N_ART)).astype(np.float32))
        lines.append(f"u{i} {data / f'u{i}.npy'}\n")
    (data / "feats.scp").write_text("".join(lines))
    return root


def _same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key], want[key]
        if key == "x":
            assert len(g) == len(w) == 1
            g, w = g[0], w[0]
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


def _m2w_batches(corpus):
    """(port batch, JAX batch) of the corpus's m2w items, one seed."""
    kwargs = dict(audio_query="*-wave.npy", mel_query="*-feats.npy",
                  audio_load_fn=np.load, mel_load_fn=np.load,
                  dataset_mode="m2w", data_root=str(corpus / "data"))
    root = str(corpus / "dump" / "tr" / "norm")
    got, want = (module.SpeechDataset(root, **kwargs)
                 for module in (datasets, jax_datasets))
    items = [got[i] for i in range(len(got))]
    for i, item in enumerate(items):
        _same(item, want[i])
        assert item["mel"].shape == (len(item["art"]), N_MELS)
    return [module.SpeechCollater(
        FRAMES * HOP, HOP, dataset_mode="m2w", config=CONFIG,
        rng=np.random.default_rng(3))(items)
        for module in (collate, jax_collate)]


def test_m2w_dataset_and_batches_match_jax(corpus):
    got, want = _m2w_batches(corpus)
    _same(got, want)
    assert got["x"][0].shape == (4, FRAMES, N_MELS)
    assert got["ar"].shape == (4, GP["ar_input"], 1)


def test_m2w_step_matches_jax_f64(corpus):
    batch = _m2w_batches(corpus)[1]
    batch = {k: batch[k] for k in ("x", "y", "ar")}
    gen = jax_models.build_model("HiFiGANGenerator", GP)
    disc = jax_models.build_model(CONFIG["discriminator_type"], DP)
    key = jax.random.PRNGKey(0)

    def init(x, ar, y):
        return (gen.init(key, x, ar=ar)["params"],
                disc.init({"params": key, "window": key}, y)["params"])

    # the inits' trees (nothing compiled) filled with seeded float64 values
    rng = np.random.default_rng(5)
    pg, pd = jax.tree.map(
        lambda s: 0.3 * rng.standard_normal(s.shape),
        jax.eval_shape(init, batch["x"][0], batch["ar"], batch["y"]))
    with jax.enable_x64(True):
        batch = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), batch)
        tx = jax_optimizer("SGD", {"lr": LR})
        state = jgan.GANTrainState(params_g=pg, params_d=pd,
                                   opt_g=tx.init(pg), opt_d=tx.init(pd),
                                   steps=jnp.asarray(1, jnp.int32))
        step = _jit(jgan.make_train_step(gen, disc,
                                         jgan.GANCriterion(CONFIG), CONFIG,
                                         tx, tx))
        new, want = jax.device_get(step(state, batch, jax.random.PRNGKey(2),
                                        jnp.float64(LR), jnp.float64(LR)))
    generator = build_model("HiFiGANGenerator", GP).double()
    generator.load_state_dict(weights.jax_params_to_state_dict(pg, GP))
    discriminator = build_model(CONFIG["discriminator_type"], DP).double()
    discriminator.load_state_dict(weights.jax_msmpd_to_state_dict(pd, DP))
    port = gan.GANTrainState(
        generator=generator, discriminator=discriminator,
        opt_g=build_optimizer("SGD", {}, -1, generator.parameters()),
        opt_d=build_optimizer("SGD", {}, -1, discriminator.parameters()),
        steps=1)
    metrics = gan.make_train_step(gan.GANCriterion(CONFIG), CONFIG)(
        port, jax.tree.map(lambda a: torch.tensor(np.asarray(a)), batch),
        LR, LR)
    assert sorted(metrics) == sorted(want) and "train/mel_loss" in metrics
    for name, value in want.items():
        np.testing.assert_allclose(float(metrics[name]), float(value),
                                   rtol=1e-8, atol=1e-10, err_msg=name)
    for model, theirs in (
            (generator, weights.jax_params_to_state_dict(new.params_g, GP)),
            (discriminator, weights.jax_msmpd_to_state_dict(new.params_d,
                                                            DP))):
        for name, value in model.state_dict().items():
            np.testing.assert_allclose(value.numpy(), theirs[name].numpy(),
                                       rtol=1e-8, atol=1e-8, err_msg=name)


def _items(mode, feature_audio=False):
    """Five utterances, one under the window (dropped by both)."""
    rng = np.random.default_rng(1)
    items = []
    for n in (23, 9, 31, 17, 40):
        audio = (rng.standard_normal((n * HOP + 5, 3)) if feature_audio
                 else rng.standard_normal(n * HOP + 5))
        items.append({"audio": audio.astype(np.float32),
                      "art": rng.standard_normal((n, N_ART)).astype(
                          np.float32),
                      "ph": rng.integers(0, 9, n + (2 if mode == "ph2a"
                                                    else 0))})
    return items


PACKING = {"a2w": ("a2w", False), "w2a": ("w2a", False),
           "w2a_features": ("w2a", True), "ph2a": ("ph2a", False)}


@pytest.mark.parametrize("name", sorted(PACKING))
@pytest.mark.parametrize("package_mode", ["window", "pad"])
def test_window_and_pad_batches_match_jax(name, package_mode):
    mode, feature_audio = PACKING[name]
    config = dict(package_mode=package_mode, pad_audio=0.5, pad_art=-1.0,
                  pad_ph=3, generator_params={})
    use_ph = mode == "ph2a"
    items = _items(mode, feature_audio)
    got, want = (module.SpeechCollater(
        FRAMES * HOP, HOP, dataset_mode=mode, use_ph=use_ph, config=config,
        rng=np.random.default_rng(0))(items)
        for module in (collate, jax_collate))
    _same(got, want)
    if package_mode == "window":
        assert got["x"][0].shape[1] in (FRAMES, FRAMES * HOP)
    else:  # the 4 kept utterances padded to the longest (40 frames)
        assert got["art"].shape == (4, 40, N_ART)


def test_window_mode_refuses_ar_windows():
    config = dict(package_mode="window",
                  generator_params={"use_ar": True, "ar_input": 32})
    with pytest.raises(NotImplementedError, match="AR windows"):
        collate.SpeechCollater(FRAMES * HOP, HOP, dataset_mode="w2a",
                               config=config)
    with pytest.raises(NotImplementedError, match="AR windows"):
        jax_collate.SpeechCollater(FRAMES * HOP, HOP, dataset_mode="w2a",
                                   config=config)(_items("w2a"))


@pytest.mark.parametrize("package_mode", ["window", "pad"])
def test_fixed_modes_refuse_mels(package_mode):
    with pytest.raises(NotImplementedError, match="mels"):
        collate.SpeechCollater(FRAMES * HOP, HOP, dataset_mode="m2w",
                               config={"package_mode": package_mode})
