"""A ``bin/train.py`` run resumed from a checkpoint continues exactly as the
uninterrupted run: 4 steps straight against its step-k checkpoint resumed
to 4, every weight and optimizer state bit for bit (CPU, one process).

The step's draws are a function of the step (``train/gan.py::RandomDraws``),
the collater's windows of the epoch, rank and batch (``data/loader.py``'s
``collate_seed``), and a resume inside an epoch starts the epoch's loader
after the batches the checkpoint had taken (``epoch_batches``). The
StyleMelGAN case draws its noise ``z`` and its discriminator's windows
every step."""

import numpy as np
import pytest
import torch
import yaml

from articulatory_tpu_torch.bin import train as train_cli
from articulatory_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

LOSSES = dict(
    sampling_rate=16000, dataset_mode="a2w", format="npy",
    generator_adv_loss_params=dict(average_by_discriminators=False),
    discriminator_adv_loss_params=dict(average_by_discriminators=False),
    lambda_aux=45.0, lambda_adv=1.0, lambda_feat_match=2.0,
    batch_size=2, num_workers=1, allow_cache=True,
    generator_optimizer_type="Adam",
    generator_optimizer_params=dict(lr=1e-4, betas=[0.5, 0.9]),
    generator_scheduler_type="MultiStepLR",
    generator_scheduler_params=dict(gamma=0.5, milestones=[3]),
    discriminator_optimizer_type="Adam",
    discriminator_optimizer_params=dict(lr=1e-4, betas=[0.5, 0.9]),
    discriminator_scheduler_type="MultiStepLR",
    discriminator_scheduler_params=dict(gamma=0.5, milestones=[3]),
    generator_train_start_steps=1, discriminator_train_start_steps=0,
    save_interval_steps=1, eval_interval_steps=2, log_interval_steps=1)
HIFICAR = dict(
    LOSSES, hop_size=80, batch_max_steps=800,
    generator_type="HiFiGANGenerator",
    generator_params=dict(
        in_channels=13 + 8, out_channels=1, channels=16, kernel_size=7,
        upsample_scales=[5, 4, 2, 2], upsample_kernel_sizes=[10, 8, 4, 4],
        resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]],
        use_ar=True, ar_input=64, ar_hidden=8, ar_output=8),
    discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
    discriminator_params=dict(
        scales=1, scale_discriminator_params=dict(
            channels=128, max_downsample_channels=128,
            downsample_scales=[4, 1]),
        periods=[2], period_discriminator_params=dict(
            channels=4, max_downsample_channels=8, downsample_scales=[3, 1])),
    use_stft_loss=False, use_mel_loss=True,
    mel_loss_params=dict(fs=16000, fft_size=256, hop_size=64, num_mels=20,
                         fmin=0, fmax=11025, log_base=None),
    use_feat_match_loss=True)
STYLE_MELGAN = dict(
    LOSSES, hop_size=8, batch_max_steps=128,
    generator_type="StyleMelGANGenerator",
    generator_params=dict(in_channels=8, aux_channels=13, channels=16,
                          noise_upsample_scales=[4, 4],
                          upsample_scales=[2, 2, 2]),
    discriminator_type="StyleMelGANDiscriminator",
    discriminator_params=dict(
        repeats=1, window_sizes=[8, 16, 32, 64],
        discriminator_params=dict(
            out_channels=1, kernel_sizes=[5, 3], channels=8,
            max_downsample_channels=32, bias=True, downsample_scales=[2, 1],
            nonlinear_activation="LeakyReLU",
            nonlinear_activation_params={"negative_slope": 0.2},
            pad="ReflectionPad1d", pad_params={})),
    use_stft_loss=True,
    stft_loss_params=dict(fft_sizes=[64], hop_sizes=[16], win_lengths=[32]),
    use_feat_match_loss=False)


def write_dump(root, hop, n_utts=4, frames=40):
    """``dump/<set>/norm/<utt>-{wave,feats}.npy`` and
    ``data/<set>/feats.scp`` under root."""
    rng = np.random.default_rng(0)
    for stage in ("tr", "dev"):
        dump = root / "dump" / stage / "norm"
        data = root / "data" / stage
        dump.mkdir(parents=True)
        data.mkdir(parents=True)
        lines = []
        for i in range(n_utts):
            n = frames + 3 * i
            np.save(dump / f"u{i}-wave.npy",
                    (0.3 * rng.standard_normal(n * hop)).astype(np.float32))
            np.save(dump / f"u{i}-feats.npy", np.zeros((n, 13), np.float32))
            np.save(data / f"u{i}.npy",
                    rng.standard_normal((n, 13)).astype(np.float32))
            lines.append(f"u{i} {data / f'u{i}.npy'}\n")
        (data / "feats.scp").write_text("".join(lines))


def cli_args(root, outdir, config_path, *extra):
    return ["--train-dumpdir", str(root / "dump/tr/norm"),
            "--dev-dumpdir", str(root / "dump/dev/norm"),
            "--outdir", str(outdir), "--config", str(config_path),
            "--data-root", str(root / "data"), "--device", "cpu",
            "--verbose", "0", "--seed", "3", *extra]


def assert_same_state(a: dict, b: dict) -> None:
    """Two checkpoints' weights and optimizer states, bit for bit."""
    assert a["steps"] == b["steps"] and a["epochs"] == b["epochs"]
    for model in a["model"]:
        for key, value in a["model"][model].items():
            assert torch.equal(value, b["model"][model][key]), (model, key)
    for model in a["optimizer"]:
        sa, sb = a["optimizer"][model]["state"], b["optimizer"][model]["state"]
        assert sorted(sa) == sorted(sb)
        for i in sa:
            for k, v in sa[i].items():
                assert torch.equal(torch.as_tensor(v),
                                   torch.as_tensor(sb[i][k])), (model, i, k)
    assert a["scheduler"] == b["scheduler"]


@pytest.mark.parametrize("name,config,resume_at", [
    # 2 batches an epoch: at 2 the checkpoint ends an epoch, at 3 it is
    # inside one
    ("hificar", HIFICAR, (2, 3)),
    ("style_melgan", STYLE_MELGAN, (2,)),  # noise and window draws
], ids=["hificar", "style_melgan"])
def test_resume_matches_uninterrupted_run(tmp_path, name, config, resume_at):
    """The uninterrupted run's checkpoint at step k, resumed in another
    directory, ends at step 4 where the run itself does."""
    write_dump(tmp_path, config["hop_size"])
    path = tmp_path / "config.yaml"
    path.write_text(yaml.dump(dict(config, train_max_steps=4)))
    straight = tmp_path / "straight"
    train_cli.main(cli_args(tmp_path, straight, path))
    want = load_checkpoint(str(straight / "checkpoint-4steps.ckpt"))
    for k in resume_at:
        ckpt = load_checkpoint(str(straight / f"checkpoint-{k}steps.ckpt"))
        assert ckpt["epoch_batches"] == (k - 1) % 2 + 1
        resumed = tmp_path / f"resumed{k}"
        train_cli.main(cli_args(tmp_path, resumed, path, "--resume",
                                str(straight / f"checkpoint-{k}steps.ckpt")))
        got = load_checkpoint(str(resumed / "checkpoint-4steps.ckpt"))
        assert_same_state(got, want)
        # and the run moved: step 4's weights differ from step k's
        assert any(not torch.equal(v, ckpt["model"]["generator"][k2])
                   for k2, v in got["model"]["generator"].items())
