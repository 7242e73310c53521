"""The repo's MRI recipe (``egs/mri/voc1/conf/mri2w_hifigan_car.yaml``:
dataset_mode ``tracks_npy_minc_punc2wav_adobe_0p9_punc``, 230 features at
20 kHz / hop 240, upsample (8, 5, 3, 2)) through the port, on the CPU, at a
narrow width: the dataset-mode rules against the JAX package's, per-chunk
decode with the carry shared against JAX (rtol 1e-4 / atol 1e-5), the
training batches of both packages from one seed, and the decode and
training CLIs on the config as the recipe has it (``format: npy``, narrow
widths, a short run)."""

import functools
import logging
import pathlib
import types

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

import flax.serialization
import jax
import jax.numpy as jnp

from articulatory_tpu import inference as jax_inference
from articulatory_tpu.bin import train as jax_train
from articulatory_tpu.data import collate as jax_collate
from articulatory_tpu.data.loader import DataLoader as JaxLoader
from articulatory_tpu.models import HiFiGANGenerator as JaxGenerator
from articulatory_tpu_torch import inference
from articulatory_tpu_torch.bin import decode as decode_cli
from articulatory_tpu_torch.bin import train as train_cli
from articulatory_tpu_torch.data import collate
from articulatory_tpu_torch.data.loader import DataLoader

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
RECIPE = (pathlib.Path(__file__).resolve().parent.parent
          / "egs/mri/voc1/conf/mri2w_hifigan_car.yaml")
N_FEATS, HOP, CHUNK = 230, 240, 10
MODES = ["a2w", "w2a", "ph2a", "ph2m", "m2w", "default", "art", "a2m", "m2a",
         "a2w_mult", "a2w_pcd", "tracks_npy_minc_punc2wav_adobe_0p9_punc",
         "ema2audio", "x2y", "nosep"]


@functools.cache
def _recipe() -> dict:
    with open(RECIPE) as f:
        return yaml.safe_load(f)


def _config(ar_input: int = 512) -> dict:
    """The recipe at a narrow width: 10-frame chunks (2400 samples); AR 512
    keeps the last-window carry, 4000 > 2400 the shift register."""
    config = dict(_recipe(), format="npy", batch_max_steps=CHUNK * HOP)
    config["generator_params"] = dict(
        config["generator_params"], in_channels=N_FEATS + 8, channels=16,
        resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]],
        ar_input=ar_input, ar_hidden=8, ar_output=8)
    return config


@functools.cache
def _params(ar_input):
    gp = _config(ar_input)["generator_params"]
    model = JaxGenerator(**{k: tuple(map(tuple, v)) if k == "resblock_dilations"
                            else tuple(v) if isinstance(v, list) else v
                            for k, v in gp.items()})
    variables = jax.jit(model.init)(jax.random.PRNGKey(3),
                                    jnp.zeros((1, CHUNK, N_FEATS)),
                                    ar=jnp.zeros((1, ar_input, 1)))
    return jax.device_get(variables["params"])


def _checkpoint(root, ar_input):
    path = root / f"mri_{ar_input}.pkl"
    if not path.exists():
        path.write_bytes(flax.serialization.msgpack_serialize(
            {"model": {"generator": _params(ar_input)}, "steps": 1}))
    return str(path)


@pytest.mark.parametrize("mode", MODES)
def test_dataset_mode_rules_match_jax(mode):
    assert collate.is_wave_output_mode(mode) == \
        jax_collate.is_wave_output_mode(mode)
    try:
        want = jax_collate.parse_dataset_mode(mode)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            collate.parse_dataset_mode(mode)
        return
    assert collate.parse_dataset_mode(mode) == want


def test_collater_takes_the_a2w_streams_only():
    config = {"generator_params": {"use_ar": True, "ar_input": 512}}
    # w2a, the same streams the other way round, since the zoo's port; the
    # phoneme modes since the conditioning's (their batches against JAX's:
    # tests/test_torch_port_cond_data.py); m2w since the training path's
    # (tests/test_torch_port_train_data.py), which refuses AR windows in
    # the window package mode, as JAX does
    for mode in ("a2w", "default", _recipe()["dataset_mode"], "x2y", "w2a",
                 "ph2a", "ph2m", "m2w"):
        collate.SpeechCollater(2400, HOP, dataset_mode=mode, config=config)
    with pytest.raises(NotImplementedError):
        collate.SpeechCollater(2400, HOP, dataset_mode="a2w",
                               config=dict(config, package_mode="window"))
    for mode in ("a2w_mult", "a2w_pcd"):
        with pytest.raises(ValueError, match="decode-only"):
            collate.SpeechCollater(2400, HOP, dataset_mode=mode, config=config)


@pytest.mark.parametrize("ar_input", [512, 4000])
def test_mri_chunks_match_jax_with_shared_carry(tmp_path, ar_input):
    config = _config(ar_input)
    path = _checkpoint(tmp_path, ar_input)
    jax_model = jax_inference.load_model(path, config)
    model = inference.load_model(path, config, device="cpu")
    x = np.random.default_rng(ar_input).standard_normal(
        (2, 3 * CHUNK, N_FEATS)).astype(np.float32)
    prev = jnp.zeros((2, ar_input, 1))
    for i in range(3):
        cin = x[:, i * CHUNK:(i + 1) * CHUNK]
        ref = np.asarray(jax_model(jnp.asarray(cin), ar=prev))
        assert ref.shape == (2, CHUNK * HOP, 1)
        np.testing.assert_allclose(model(cin, ar=np.array(prev)).numpy(), ref,
                                   **TOL, err_msg=f"chunk {i}")
        prev = (jnp.asarray(ref)[:, -ar_input:] if ar_input <= CHUNK * HOP
                else jnp.concatenate([prev[:, ref.shape[1]:],
                                      jnp.asarray(ref)], 1))
    # the loop's first chunk is the first chunk above
    out = inference.ar_loop(model, x[0, :CHUNK + 3], config)
    assert out.shape == ((CHUNK + 3) * HOP,)
    first = np.asarray(jax_model(jnp.asarray(x[:1, :CHUNK]),
                                 ar=jnp.zeros((1, ar_input, 1))))
    np.testing.assert_allclose(out[:CHUNK * HOP], first[0, :, 0], **TOL)


def _corpus(root, n_utts=4, frames=45, feats=N_FEATS, hop=HOP):
    """``dump/<set>/norm/<utt>-{wave,feats}.npy`` and ``data/<set>/feats.scp``
    (the features) under root."""
    rng = np.random.default_rng(0)
    for stage in ("tr", "dev"):
        dump, data = root / "dump" / stage / "norm", root / "data" / stage
        dump.mkdir(parents=True)
        data.mkdir(parents=True)
        lines = []
        for i in range(n_utts):
            art = rng.standard_normal((frames, feats)).astype(np.float32)
            np.save(dump / f"u{i}-wave.npy", (0.3 * rng.standard_normal(
                frames * hop)).astype(np.float32))
            np.save(dump / f"u{i}-feats.npy", art)
            np.save(data / f"u{i}.npy", art)
            lines.append(f"u{i} {data / f'u{i}.npy'}\n")
        (data / "feats.scp").write_text("".join(lines))


def test_mri_batches_match_the_jax_loader(tmp_path, caplog):
    """Both packages' ``build_datasets`` on the recipe's config: the same
    crops and AR windows from one seed."""
    _corpus(tmp_path)
    config = _config()
    dirs = dict(train_dumpdir=str(tmp_path / "dump/tr/norm"),
                dev_dumpdir=str(tmp_path / "dump/dev/norm"),
                data_root=str(tmp_path / "data"))
    with caplog.at_level(logging.WARNING):
        ours = train_cli.build_datasets(config, **dirs)
    assert "resolving to 'art'" in caplog.text  # the x2y warnings
    theirs = jax_train.build_datasets(types.SimpleNamespace(**dirs), config)
    loaders = [(DataLoader(ours[0], batch_size=2, shuffle=True,
                           collate_fn=ours[2], drop_last=True, seed=3)),
               JaxLoader(theirs[0], batch_size=2, shuffle=True,
                         collate_fn=theirs[2], drop_last=True, seed=3)]
    n = 0
    for a, b in zip(*loaders):
        assert a["x"][0].shape == (2, CHUNK, N_FEATS)
        assert a["y"].shape == (2, CHUNK * HOP, 1) and a["ar"].shape == (2, 512, 1)
        for key in ("y", "ar"):
            np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(a["x"][0], b["x"][0])
        n += 1
    assert n == 2


def test_mri_decode_cli(tmp_path):
    config = _config()
    cfg = tmp_path / "config.yml"
    cfg.write_text(yaml.dump(config))
    dump = tmp_path / "dump"
    dump.mkdir()
    rng = np.random.default_rng(9)
    xs = [rng.standard_normal((t, N_FEATS)).astype(np.float32) for t in (25, 12)]
    for i, x in enumerate(xs):
        np.save(dump / f"m{i}-feats.npy", x)
    path = _checkpoint(tmp_path, 512)
    model = inference.load_model(path, config, device="cpu")
    for extra in ([], ["--ar-scan"]):
        out = tmp_path / f"out{len(extra)}"
        decode_cli.main(["--dumpdir", str(dump), "--checkpoint", path,
                         "--config", str(cfg), "--outdir", str(out),
                         "--device", "cpu", "--verbose", "0", *extra])
        for i, x in enumerate(xs):
            sr, wav = wavfile.read(out / f"m{i}_gen.wav")
            assert sr == 20000 and wav.shape == (len(x) * HOP,)
            ref = (inference.ar_loop_scan(model, x, config, chunk_bucket=4)
                   if extra else inference.ar_loop(model, x, config))
            np.testing.assert_allclose(
                wav, (np.clip(ref, -1, 1) * 32767).astype(np.int16), atol=1)


def test_mri_recipe_trains(tmp_path):
    """The recipe's config as it stands (``time_packing: auto`` included),
    but ``format: npy``, narrow widths, batch 2 and one step; then a decode
    from the checkpoint."""
    _corpus(tmp_path, n_utts=2, frames=30)
    config = _config()
    config.update(
        batch_size=2, num_workers=1, train_max_steps=1, save_interval_steps=1,
        eval_interval_steps=1, log_interval_steps=1,
        discriminator_params=dict(
            config["discriminator_params"], scales=1, periods=[2],
            scale_discriminator_params=dict(
                config["discriminator_params"]["scale_discriminator_params"],
                max_downsample_channels=128, downsample_scales=[4, 1]),
            period_discriminator_params=dict(
                config["discriminator_params"]["period_discriminator_params"],
                channels=4, max_downsample_channels=8,
                downsample_scales=[3, 1])),
        mel_loss_params=dict(config["mel_loss_params"], fft_size=256,
                             hop_size=64, num_mels=20))
    assert config["time_packing"] == "auto"
    path = tmp_path / "config.yaml"
    path.write_text(yaml.dump(config))
    out = tmp_path / "exp"
    train_cli.main(["--train-dumpdir", str(tmp_path / "dump/tr/norm"),
                    "--dev-dumpdir", str(tmp_path / "dump/dev/norm"),
                    "--outdir", str(out), "--config", str(path),
                    "--data-root", str(tmp_path / "data"), "--device", "cpu",
                    "--verbose", "0"])
    model = inference.load_model(str(out / "checkpoint-1steps.ckpt"),
                                 device="cpu")
    feats = np.load(tmp_path / "data/dev/u0.npy")[:CHUNK]
    wav = inference.ar_loop(model, feats, model.config)
    assert wav.shape == (CHUNK * HOP,) and np.isfinite(wav).all()
