"""``python -m articulatory_tpu_torch.bin.train --device cpu`` end to end on
a tiny npy dump written here: two steps write their checkpoints, ``--resume``
continues from one, and ``inference.load_model`` decodes a chunk from the
result. Also: the port's loader and collater draw the same batches as the
JAX package's from one seed, and the entry point raises without a card."""

import numpy as np
import pytest
import torch
import yaml

from articulatory_tpu.data.collate import SpeechCollater as JaxCollater
from articulatory_tpu.data.datasets import SpeechDataset as JaxDataset
from articulatory_tpu.data.loader import DataLoader as JaxLoader
from articulatory_tpu_torch import inference
from articulatory_tpu_torch.bin import train as train_cli
from articulatory_tpu_torch.data.collate import SpeechCollater
from articulatory_tpu_torch.data.datasets import SpeechDataset
from articulatory_tpu_torch.data.loader import DataLoader
from articulatory_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

GP = dict(in_channels=13 + 8, out_channels=1, channels=16, kernel_size=7,
          upsample_scales=[5, 4, 2, 2], upsample_kernel_sizes=[10, 8, 4, 4],
          resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]],
          use_ar=True, ar_input=64, ar_hidden=8, ar_output=8)
DP = dict(scales=1, scale_discriminator_params=dict(
    channels=128, max_downsample_channels=128, downsample_scales=[4, 1]),
    periods=[2], period_discriminator_params=dict(
        channels=4, max_downsample_channels=8, downsample_scales=[3, 1]))
CONFIG = dict(
    sampling_rate=16000, hop_size=80, dataset_mode="a2w", format="npy",
    generator_type="HiFiGANGenerator", generator_params=GP,
    discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
    discriminator_params=DP, use_stft_loss=False, use_mel_loss=True,
    mel_loss_params=dict(fs=16000, fft_size=256, hop_size=64, num_mels=20,
                         fmin=0, fmax=11025, log_base=None),
    generator_adv_loss_params=dict(average_by_discriminators=False),
    discriminator_adv_loss_params=dict(average_by_discriminators=False),
    use_feat_match_loss=True, lambda_aux=45.0, lambda_feat_match=2.0,
    batch_size=2, batch_max_steps=800, num_workers=1, allow_cache=True,
    generator_optimizer_type="Adam",
    generator_optimizer_params=dict(lr=1e-4, betas=[0.5, 0.9]),
    generator_scheduler_type="MultiStepLR",
    generator_scheduler_params=dict(gamma=0.5, milestones=[2]),
    discriminator_optimizer_type="Adam",
    discriminator_optimizer_params=dict(lr=1e-4, betas=[0.5, 0.9]),
    discriminator_scheduler_type="MultiStepLR",
    discriminator_scheduler_params=dict(gamma=0.5, milestones=[2]),
    generator_train_start_steps=1, discriminator_train_start_steps=0,
    train_max_steps=2, save_interval_steps=1, eval_interval_steps=2,
    log_interval_steps=1)


def _dump(root, n_utts=3, frames=30):
    """``dump/<set>/norm/<utt>-{wave,feats}.npy`` and
    ``data/<set>/feats.scp`` (the articulatory features) under root."""
    rng = np.random.default_rng(0)
    for stage in ("tr", "dev"):
        dump = root / "dump" / stage / "norm"
        data = root / "data" / stage
        dump.mkdir(parents=True)
        data.mkdir(parents=True)
        lines = []
        for i in range(n_utts):
            np.save(dump / f"u{i}-wave.npy",
                    (0.3 * rng.standard_normal(frames * 80)).astype(np.float32))
            np.save(dump / f"u{i}-feats.npy", np.zeros((frames, 13), np.float32))
            art = data / f"u{i}.npy"
            np.save(art, rng.standard_normal((frames, 13)).astype(np.float32))
            lines.append(f"u{i} {art}\n")
        (data / "feats.scp").write_text("".join(lines))


def _args(root, outdir, config_path, *extra):
    return ["--train-dumpdir", str(root / "dump/tr/norm"),
            "--dev-dumpdir", str(root / "dump/dev/norm"),
            "--outdir", str(outdir), "--config", str(config_path),
            "--data-root", str(root / "data"), "--device", "cpu",
            "--verbose", "0", *extra]


def test_train_resume_and_decode(tmp_path):
    _dump(tmp_path)
    config_path = tmp_path / "config.yaml"
    config_path.write_text(yaml.dump(CONFIG))
    out = tmp_path / "exp"
    train_cli.main(_args(tmp_path, out, config_path))
    for name in ("checkpoint-1steps.ckpt", "checkpoint-2steps.ckpt",
                 "best_mel_ckpt.pkl", "best_mel_step.txt", "config.yml"):
        assert (out / name).exists(), name
    first = load_checkpoint(str(out / "checkpoint-2steps.ckpt"))
    assert first["steps"] == 2 and first["epochs"] == 1  # 1 batch an epoch
    # schedulers step while steps > their start step: G at none of 0, 1
    assert [first["scheduler"][m]["step_count"]
            for m in ("generator", "discriminator")] == [0, 1]

    config_path.write_text(yaml.dump(dict(CONFIG, train_max_steps=3)))
    train_cli.main(_args(tmp_path, out, config_path, "--resume",
                         str(out / "checkpoint-2steps.ckpt")))
    last = load_checkpoint(str(out / "checkpoint-3steps.ckpt"))
    assert last["steps"] == 3
    assert [last["scheduler"][m]["step_count"]
            for m in ("generator", "discriminator")] == [1, 2]
    assert last["scheduler"]["discriminator"]["lr"] == pytest.approx(5e-5)
    # the resumed step moved both models on from the resumed weights
    for model in ("generator", "discriminator"):
        assert any(not torch.equal(last["model"][model][k], v)
                   for k, v in first["model"][model].items())
    # Adam's step counts carried over: no generator and one discriminator
    # update before the resume (steps 0, 1), one more of each after
    steps = {m: max(int(s["step"]) for s in last["optimizer"][m]["state"]
                    .values()) for m in ("generator", "discriminator")}
    assert steps == {"generator": 1, "discriminator": 2}

    model = inference.load_model(str(out / "checkpoint-3steps.ckpt"),
                                 device="cpu")  # config.yml beside it
    feats = np.random.default_rng(1).standard_normal((10, 13)).astype(np.float32)
    wav = inference.ar_loop(model, feats, model.config)
    assert wav.shape == (800,) and np.isfinite(wav).all()


def test_batches_match_the_jax_loader(tmp_path):
    _dump(tmp_path, n_utts=5)
    kwargs = dict(root_dir=str(tmp_path / "dump/tr/norm"),
                  audio_query="*-wave.npy", mel_query="*-feats.npy",
                  audio_load_fn=np.load, data_root=str(tmp_path / "data"))
    config = dict(CONFIG, generator_params=dict(GP, ar_input=100))
    loaders = []
    for dataset_cls, collater_cls, loader_cls in (
            (SpeechDataset, SpeechCollater, DataLoader),
            (JaxDataset, JaxCollater, JaxLoader)):
        collater = collater_cls(batch_max_steps=800, hop_size=80,
                                dataset_mode="a2w", config=config,
                                rng=np.random.default_rng(7))
        loaders.append(loader_cls(dataset_cls(**kwargs), batch_size=2,
                                  shuffle=True, collate_fn=collater,
                                  drop_last=True, seed=3))
    for epoch in range(2):
        for loader in loaders:
            loader.set_epoch(epoch)
        pairs = list(zip(*loaders))
        assert len(pairs) == 2
        for ours, theirs in pairs:
            for key in ("y", "ar"):
                np.testing.assert_array_equal(ours[key], theirs[key])
            np.testing.assert_array_equal(ours["x"][0], theirs["x"][0])


def test_hdf5_dataset_matches_the_jax_dataset(tmp_path):
    """``format: hdf5``: audio from the dump's .h5 files ("wave")."""
    import h5py

    _dump(tmp_path)
    dump = tmp_path / "dump/tr/norm"
    for i in range(3):
        with h5py.File(dump / f"u{i}.h5", "w") as f:
            f["wave"] = np.load(dump / f"u{i}-wave.npy")
            f["feats"] = np.load(dump / f"u{i}-feats.npy")
    kwargs = dict(root_dir=str(dump), audio_query="*.h5", mel_query="*.h5",
                  data_root=str(tmp_path / "data"))
    ours, theirs = SpeechDataset(**kwargs), JaxDataset(**kwargs)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        for key in ("art", "audio"):
            np.testing.assert_array_equal(ours[i][key], theirs[i][key])


def test_train_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.train(CONFIG, train_dumpdir=str(tmp_path),
                        dev_dumpdir=str(tmp_path), outdir=str(tmp_path))
    # a rank of a process group asked for a card raises before it joins
    config_path = tmp_path / "config.yaml"
    config_path.write_text(yaml.dump(CONFIG))
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--train-dumpdir", "a", "--dev-dumpdir", "b",
                        "--outdir", str(tmp_path), "--config",
                        str(config_path), "--num-processes", "2",
                        "--process-id", "1", "--coordinator-address",
                        f"file://{tmp_path / 'rendezvous'}"])
