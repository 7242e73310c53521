"""The conditioning through the port's CLIs on the CPU, on tiny npy corpora
written here:

- ``bin/train.py`` with a speaker- and phoneme-conditioned HiFi-CAR with
  the phoneme head (``utt2spk``, ``ph.scp``): two steps, finite losses with
  ``train/ph_loss`` above 0, the speaker count checked against
  ``num_spk``, and ``use_pcd`` refused (no collater makes its tracks);
- a cascade through ``main`` with ``--pretrain2``: generator2 and the
  discriminator come from the second checkpoint, generator2 stays bit for
  bit through the steps, and the written checkpoint's ``generator2`` loads
  back through ``load_model(generator2=True)``;
- ``bin/decode.py`` in ph2a and ph2m (integer phoneme ids from the dump
  into a trained Transformer), and in a2w_mult (a 3-column feats.scp
  through ``ar_loop(modality=...)``, with an in-list model: none of the
  registry reads one), whose outputs equal the loop's.
"""

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile
from torch import nn

from articulatory_tpu_torch import inference
from articulatory_tpu_torch.bin import decode as decode_cli
from articulatory_tpu_torch.bin import train as train_cli
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

HOP = 16
DP = dict(scales=1, scale_discriminator_params=dict(
    channels=8, max_downsample_channels=16, max_groups=2,
    downsample_scales=[2, 1]), periods=[2], period_discriminator_params=dict(
        channels=2, max_downsample_channels=4, downsample_scales=[3, 1]))
TRAIN_KEYS = dict(
    format="npy", batch_size=2, num_workers=0, allow_cache=True,
    generator_adv_loss_params=dict(average_by_discriminators=False),
    discriminator_adv_loss_params=dict(average_by_discriminators=False),
    use_feat_match_loss=False, lambda_aux=1.0, lambda_ph=0.5,
    generator_optimizer_type="Adam",
    generator_optimizer_params=dict(lr=1e-4, betas=[0.5, 0.9]),
    discriminator_optimizer_type="Adam",
    discriminator_optimizer_params=dict(lr=1e-4, betas=[0.5, 0.9]),
    generator_scheduler_type="MultiStepLR",
    generator_scheduler_params=dict(gamma=0.5, milestones=[10]),
    discriminator_scheduler_type="MultiStepLR",
    discriminator_scheduler_params=dict(gamma=0.5, milestones=[10]),
    generator_train_start_steps=0, discriminator_train_start_steps=0,
    train_max_steps=2, save_interval_steps=2, eval_interval_steps=2,
    log_interval_steps=100)
COND_GP = dict(in_channels=13 + 8, channels=16, upsample_scales=[4, 4],
               upsample_kernel_sizes=[8, 8], resblock_kernel_sizes=[3],
               resblock_dilations=[[1, 3]], use_ar=True, ar_input=32,
               ar_hidden=8, ar_output=8, use_spk_id=True, num_spk=2,
               use_ph=True, num_ph=6, ph_emb_size=3, use_ph_loss=True)
COND = dict(TRAIN_KEYS, sampling_rate=16000, hop_size=HOP, dataset_mode="a2w",
            batch_max_steps=10 * HOP, use_stft_loss=True,
            stft_loss_params=dict(fft_sizes=[64], hop_sizes=[16],
                                  win_lengths=[32]),
            generator_type="HiFiGANGenerator", generator_params=COND_GP,
            discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
            discriminator_params=DP)


def _dump(root, stream, art, hop=HOP, frames=30, ids=None):
    """``dump/<set>/norm/<utt>-{wave,feats}.npy``, ``data/<set>/feats.scp``,
    ``utt2spk`` (speakers s0 and s1 in turns) and ``ph.scp`` (ids below 6)
    for 3 utterances a set. ``stream(n)`` and ``art(n)`` make an
    utterance's audio stream and its articulatory target of n frames;
    ``ids`` the ``-feats.npy`` file (default the art)."""
    rng = np.random.default_rng(0)
    for stage in ("tr", "dev"):
        dump, data = root / "dump" / stage / "norm", root / "data" / stage
        dump.mkdir(parents=True)
        data.mkdir(parents=True)
        scp, spk, ph = [], [], []
        for i in range(3):
            n = frames + 5 * i
            a = art(rng, n)
            np.save(dump / f"u{i}-wave.npy", stream(rng, n * hop))
            np.save(dump / f"u{i}-feats.npy", a if ids is None else ids(n))
            np.save(data / f"u{i}.npy", a)
            np.save(data / f"u{i}-ph.npy", rng.integers(0, 6, n))
            scp.append(f"u{i} {data / f'u{i}.npy'}\n")
            spk.append(f"u{i} s{i % 2}\n")
            ph.append(f"u{i} {data / f'u{i}-ph.npy'}\n")
        (data / "feats.scp").write_text("".join(scp))
        (data / "utt2spk").write_text("".join(spk))
        (data / "ph.scp").write_text("".join(ph))


def _wave(rng, n):
    return (0.3 * rng.standard_normal(n)).astype(np.float32)


def _feats(width):
    return lambda rng, n: rng.standard_normal((n, width)).astype(np.float32)


def _train(root, config, **kwargs):
    return train_cli.train(
        config, train_dumpdir=str(root / "dump/tr/norm"),
        dev_dumpdir=str(root / "dump/dev/norm"), outdir=str(root / "exp"),
        data_root=str(root / "data"), device="cpu", **kwargs)


def test_train_conditioned_hifigan(tmp_path):
    _dump(tmp_path, _wave, _feats(13))
    trainer = _train(tmp_path, COND)
    assert trainer.steps == 2
    losses = {k: float(v) for k, v in trainer.total_train_loss.items()}
    assert all(np.isfinite(v) for v in losses.values())
    assert losses["train/ph_loss"] > 0
    ckpt = load_checkpoint(str(tmp_path / "exp" / "checkpoint-2steps.ckpt"))
    assert ckpt["model"]["generator"]["spk_emb_mat.weight"].shape == (2, 32)
    assert ckpt["model"]["generator"]["ph_fc.weight"].shape == (6, 4)
    with pytest.raises(ValueError, match="num_spk"):
        _train(tmp_path, dict(COND, generator_params=dict(COND_GP,
                                                          num_spk=3)))
    with pytest.raises(ValueError, match="use_pcd"):
        _train(tmp_path, dict(COND, use_pcd=True))


W2A = dict(TRAIN_KEYS, sampling_rate=200, hop_size=1, dataset_mode="w2a",
           batch_max_steps=12, use_stft_loss=False, use_mel_loss=True)
GEN2 = dict(in_channels=4, out_channels=5, channels=16, upsample_scales=[1],
            upsample_kernel_sizes=[2], resblock_kernel_sizes=[3],
            resblock_dilations=[[1]])


def test_train_cascade_with_pretrain2(tmp_path):
    """A BiGRU (5 features -> 4) into a frozen scale-1 HiFi-GAN (4 -> 5)
    judged against its input; --pretrain2 loads generator2 and the
    discriminator, which stays put (its updates start after the run)."""
    _dump(tmp_path, _feats(5), _feats(4), hop=1)
    config = dict(W2A, generator_type="BiGRU", generator_params=dict(
        in_channels=5, hidden_size=8, out_channels=4, dropout=0.0),
        generator2_type="HiFiGANGenerator", generator2_params=GEN2,
        discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
        discriminator_params=dict(DP, scale_discriminator_params=dict(
            DP["scale_discriminator_params"], in_channels=5),
            period_discriminator_params=dict(
                DP["period_discriminator_params"], in_channels=5)),
        discriminator_train_start_steps=10)
    stage2 = {"generator": build_model("HiFiGANGenerator", GEN2,
                                       seed=7).state_dict(),
              "discriminator": build_model(config["discriminator_type"],
                                           config["discriminator_params"],
                                           seed=8).state_dict()}
    torch.save({"model": stage2}, tmp_path / "stage2.pkl")
    (tmp_path / "config.yml").write_text(yaml.dump(config))
    train_cli.main([
        "--train-dumpdir", str(tmp_path / "dump/tr/norm"),
        "--dev-dumpdir", str(tmp_path / "dump/dev/norm"),
        "--outdir", str(tmp_path / "exp"),
        "--config", str(tmp_path / "config.yml"),
        "--data-root", str(tmp_path / "data"), "--device", "cpu",
        "--pretrain2", str(tmp_path / "stage2.pkl")])
    path = str(tmp_path / "exp" / "checkpoint-2steps.ckpt")
    written = load_checkpoint(path)["model"]
    for key in ("generator", "discriminator"):
        got = written["generator2" if key == "generator" else key]
        assert sorted(got) == sorted(stage2[key])
        for name, value in stage2[key].items():
            assert torch.equal(got[name], value), (key, name)
    initial = build_model("BiGRU", config["generator_params"]).state_dict()
    assert not torch.equal(written["generator"]["fc2.weight"],
                           initial["fc2.weight"])
    second = inference.load_model(path, config, generator2=True,
                                  device="cpu")
    for name, value in second.model.state_dict().items():
        assert torch.equal(value, stage2["generator"][name]), name


@pytest.mark.parametrize("mode", ["ph2a", "ph2m"])
def test_phoneme_modes_train_and_decode(tmp_path, mode):
    """A Transformer on phoneme ids: ph2a to 4 articulatory features (the
    art through feats.scp), ph2m to 3 mel bins (the mels in the dump);
    the decode reads integer ids from the dump's ``-feats.npy``."""
    width = 4 if mode == "ph2a" else 3
    _dump(tmp_path, _wave, _feats(width), hop=1,
          ids=lambda n: np.arange(n) % 6)
    config = dict(W2A, dataset_mode=mode, generator_type="Transformer",
                  generator_params=dict(in_channels=3, out_channels=width,
                                        hidden_dim=16, elayers=1, dropout=0.0,
                                        num_ph=6, ph_emb_size=3),
                  discriminator_type="ParallelWaveGANDiscriminator",
                  discriminator_params=dict(in_channels=width, layers=3,
                                            conv_channels=8))
    if mode == "ph2m":  # the dump's -feats.npy are its mels
        for stage in ("tr", "dev"):
            for i in range(3):
                dump = tmp_path / "dump" / stage / "norm"
                np.save(dump / f"u{i}-feats.npy",
                        np.load(tmp_path / "data" / stage / f"u{i}.npy"))
    trainer = _train(tmp_path, config)
    assert trainer.steps == 2
    assert all(np.isfinite(float(v))
               for v in trainer.total_train_loss.values())
    dump = tmp_path / "eval"
    dump.mkdir()
    for i, n in enumerate((17, 40)):
        np.save(dump / f"e{i}-feats.npy", (np.arange(n) * 5 % 6))
    out = tmp_path / "out"
    decode_cli.decode(dict(config, generator_params=config[
        "generator_params"]), str(tmp_path / "exp" / "checkpoint-2steps.ckpt"),
        str(out), dumpdir=str(dump), device="cpu")
    for i, n in enumerate((17, 40)):
        y = np.load(out / f"e{i}_gen.npy")
        assert y.shape == (n, width) and np.isfinite(y).all()


class _InList(nn.Module):
    """An in-list AR model: the present modality's frames through a conv
    to 1 channel, repeated to the hop, plus the carry's mean."""

    def __init__(self, widths, hop):
        super().__init__()
        self.hop = hop
        self.proj = nn.ModuleList([nn.Linear(w, 1) for w in widths])

    def forward(self, cin_list, ar):
        m, c = next((i, c) for i, c in enumerate(cin_list) if c is not None)
        y = torch.tanh(self.proj[m](c)).repeat_interleave(self.hop, dim=1)
        return y + ar.mean(dim=1, keepdim=True)

    def remove_weight_norm(self):
        pass


def test_decode_a2w_mult(tmp_path, monkeypatch, caplog):
    hop = 4
    config = {"dataset_mode": "a2w_mult", "sampling_rate": 16000,
              "hop_size": hop, "batch_max_steps": 10 * hop,
              "hop_sizes": [hop, 2 * hop], "sampling_rates": [16000, 16000],
              "generator_type": "HiFiGANGenerator", "generator_params": {
                  "out_channels": 1, "use_ar": True, "ar_input": 24,
                  "in_list": ["ema", "mri"]}}
    model = inference.LoadedModel(model=_InList([3, 5], hop).eval(),
                                  config=config, device=torch.device("cpu"))
    monkeypatch.setattr(decode_cli, "load_model", lambda *a, **k: model)
    rng = np.random.default_rng(1)
    lines, xs = [], {}
    for uid, mod, shape in (("a", 0, (27, 3)), ("b", 1, (13, 5)),
                            ("c", 0, (10, 3))):
        xs[uid] = (rng.standard_normal(shape).astype(np.float32), mod)
        np.save(tmp_path / f"{uid}.npy", xs[uid][0])
        lines.append(f"{uid} {tmp_path / f'{uid}.npy'} {mod}\n")
    (tmp_path / "feats.scp").write_text("".join(lines))
    with pytest.raises(ValueError, match="3-column"):
        decode_cli.decode(config, "unused", str(tmp_path / "o"),
                          dumpdir=str(tmp_path), device="cpu")
    for kwargs in ({}, {"ar_scan": True, "decode_batch_size": 2}):
        out = tmp_path / f"out{len(kwargs)}"
        result = decode_cli.decode(config, "unused", str(out),
                                   feats_scp=str(tmp_path / "feats.scp"),
                                   device="cpu", **kwargs)
        assert result["utterances"] == 3
        for uid, (x, mod) in xs.items():
            want = inference.ar_loop(model, x, config, modality=mod)
            sr, wav = wavfile.read(out / f"{uid}_gen.wav")
            # modality 1's frames come at half the rate: twice the samples
            assert sr == 16000
            assert len(wav) == len(want) == len(x) * hop * (1 + mod)
            # PCM_16: the clipped wave times 32767, truncated
            np.testing.assert_allclose(wav / 32767.0, np.clip(want, -1, 1),
                                       atol=1.01 / 32767.0)
    assert "--ar-scan ignored" in caplog.text
