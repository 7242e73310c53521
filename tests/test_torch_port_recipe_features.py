"""The recipe's stage 1 without JAX: ``logmelfilterbank_np``, the port's
``bin/preprocess.py``, ``bin/compute_statistics.py`` and ``bin/normalize.py``
against the JAX package's CLIs on the same small corpus. Dumps are compared
bit for bit, the statistics at rtol 1e-6 (the port's accumulator replaces
scikit-learn's ``StandardScaler``)."""

import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from articulatory_tpu.bin import compute_statistics as jax_stats
from articulatory_tpu.bin import normalize as jax_normalize
from articulatory_tpu.bin import preprocess as jax_preprocess
from articulatory_tpu.ops.stft import logmelfilterbank_np as jax_logmel
from articulatory_tpu_torch.bin import compute_statistics, normalize, preprocess
from articulatory_tpu_torch.ops.mel import logmelfilterbank_np
from articulatory_tpu_torch.utils.io import find_files, read_hdf5

torch.set_num_threads(1)

SR = 16000
CONFIG = dict(sampling_rate=SR, fft_size=256, hop_size=80, win_length=None,
              window="hann", num_mels=20, fmin=80, fmax=7600,
              global_gain_scale=1.0, trim_silence=True,
              trim_threshold_in_db=20, trim_frame_size=256, trim_hop_size=80)


@pytest.mark.parametrize("kwargs", [
    dict(fft_size=256, hop_size=80, num_mels=20, fmin=80, fmax=7600),
    dict(fft_size=512, hop_size=128, win_length=400, num_mels=40,
         log_base=None),
    dict(fft_size=256, hop_size=64, num_mels=16, log_base=2.0)])
def test_logmelfilterbank_np_matches_jax(kwargs):
    audio = np.random.default_rng(0).standard_normal(3001).astype(np.float32)
    np.testing.assert_array_equal(logmelfilterbank_np(audio, SR, **kwargs),
                                  jax_logmel(audio, SR, **kwargs))


def _corpus(root):
    """Four 16-bit wavs with silence around a tone and noise; u3 is loud
    enough to clip under a gain of 1.5. Returns the wav.scp path."""
    rng = np.random.default_rng(1)
    wavs = root / "wav"
    wavs.mkdir()
    lines = []
    for i, (seconds, amp) in enumerate(((0.5, 0.3), (0.35, 0.5), (0.6, 0.2),
                                        (0.4, 0.9))):
        n = int(seconds * SR)
        t = np.arange(n) / SR
        voice = amp * (0.7 * np.sin(2 * np.pi * (150 + 40 * i) * t)
                       + 0.3 * rng.uniform(-1, 1, n))
        wave = np.concatenate([np.zeros(1200), voice, np.zeros(900)])
        path = wavs / f"u{i}.wav"
        wavfile.write(path, SR, (wave * 32767).astype(np.int16))
        lines.append(f"u{i} {path}\n")
    scp = root / "wav.scp"
    scp.write_text("".join(lines))
    return scp


def _outputs(dumpdir, fmt):
    """name -> array of every dump file."""
    out = {}
    if fmt == "npy":
        for path in find_files(str(dumpdir), "*.npy"):
            out[path.split("/")[-1]] = np.load(path)
    else:
        for path in find_files(str(dumpdir), "*.h5"):
            for key in ("wave", "feats", "mean", "scale"):
                try:
                    out[f"{path.split('/')[-1]}:{key}"] = read_hdf5(path, key)
                except KeyError:
                    pass
    return out


def _assert_same(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype, key
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


def _run_jax(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    module.main()


@pytest.mark.parametrize("fmt,source,resample", [
    ("npy", "scp", False), ("hdf5", "scp", True), ("npy", "rootdir", True)])
def test_preprocess_matches_jax(tmp_path, monkeypatch, fmt, source, resample):
    scp = _corpus(tmp_path)
    config = dict(CONFIG, format=fmt, global_gain_scale=1.5)
    if resample:
        config.update(sampling_rate_for_feats=8000, fmax=3800)
    conf = tmp_path / "conf.yaml"
    conf.write_text(yaml.dump(config))
    inputs = (["--wav-scp", str(scp)] if source == "scp"
              else ["--rootdir", str(tmp_path / "wav")])
    for name, run in (("ours", lambda a: preprocess.main(a)),
                      ("theirs", lambda a: _run_jax(monkeypatch,
                                                    jax_preprocess, a))):
        run([*inputs, "--dumpdir", str(tmp_path / name), "--config",
             str(conf), "--verbose", "0"])
    ours, theirs = _outputs(tmp_path / "ours", fmt), _outputs(
        tmp_path / "theirs", fmt)
    _assert_same(ours, theirs)
    # u3 clips under the gain and is skipped; the rest were trimmed
    assert len(ours) == 6 and not any(k.startswith("u3") for k in ours)
    wave = ours["u0-wave.npy" if fmt == "npy" else "u0.h5:wave"]
    feats = ours["u0-feats.npy" if fmt == "npy" else "u0.h5:feats"]
    assert len(wave) == len(feats) * CONFIG["hop_size"]
    assert len(wave) < 0.5 * SR + 2100


@pytest.mark.parametrize("fmt", ["npy", "hdf5"])
def test_statistics_and_normalize_match_jax(tmp_path, monkeypatch, fmt):
    scp = _corpus(tmp_path)
    conf = tmp_path / "conf.yaml"
    conf.write_text(yaml.dump(dict(CONFIG, format=fmt)))
    raw = tmp_path / "raw"
    preprocess.main(["--wav-scp", str(scp), "--dumpdir", str(raw),
                     "--config", str(conf), "--verbose", "0"])
    # a constant feature dimension: its scale is 1, not ~0
    for i in range(4):
        if fmt == "npy":
            path = raw / f"u{i}-feats.npy"
            mel = np.load(path)
            mel[:, 3] = 0.25
            np.save(path, mel)
        else:
            from articulatory_tpu_torch.utils.io import write_hdf5

            mel = read_hdf5(str(raw / f"u{i}.h5"), "feats")
            mel[:, 3] = 0.25
            write_hdf5(str(raw / f"u{i}.h5"), "feats", mel)
    stats = {}
    for name, stats_main, norm_main in (
            ("ours", compute_statistics.main, normalize.main),
            ("theirs", lambda a: _run_jax(monkeypatch, jax_stats, a),
             lambda a: _run_jax(monkeypatch, jax_normalize, a))):
        stats_main(["--rootdir", str(raw), "--dumpdir", str(tmp_path / name),
                    "--config", str(conf), "--verbose", "0"])
        stats_file = tmp_path / name / ("stats.npy" if fmt == "npy"
                                        else "stats.h5")
        stats[name] = (np.load(stats_file) if fmt == "npy" else np.stack(
            [read_hdf5(str(stats_file), k) for k in ("mean", "scale")]))
        norm_main(["--rootdir", str(raw), "--dumpdir",
                   str(tmp_path / name / "norm"), "--stats", str(stats_file),
                   "--config", str(conf), "--verbose", "0"])
    np.testing.assert_allclose(stats["ours"], stats["theirs"], rtol=1e-6)
    assert stats["ours"][1, 3] == 1.0 and stats["ours"][0, 3] == 0.25
    _assert_same(_outputs(tmp_path / "ours" / "norm", fmt),
                 _outputs(tmp_path / "theirs" / "norm", fmt))


@pytest.mark.parametrize("skip_wav", [False, True])
def test_normalize_scp_path_matches_jax(tmp_path, monkeypatch, skip_wav):
    scp = _corpus(tmp_path)
    conf = tmp_path / "conf.yaml"
    conf.write_text(yaml.dump(dict(CONFIG, format="npy")))
    raw = tmp_path / "raw"
    preprocess.main(["--wav-scp", str(scp), "--dumpdir", str(raw),
                     "--config", str(conf), "--verbose", "0"])
    feats_scp = tmp_path / "feats.scp"
    feats_scp.write_text("".join(f"u{i} {raw}/u{i}-feats.npy\n"
                                 for i in range(4)))
    compute_statistics.main(["--feats-scp", str(feats_scp), "--dumpdir",
                             str(tmp_path), "--config", str(conf),
                             "--verbose", "0"])
    args = ["--feats-scp", str(feats_scp), "--stats",
            str(tmp_path / "stats.npy"), "--config", str(conf),
            "--verbose", "0"]
    args += ["--skip-wav-copy"] if skip_wav else ["--wav-scp", str(scp)]
    normalize.main([*args, "--dumpdir", str(tmp_path / "ours")])
    _run_jax(monkeypatch, jax_normalize,
             [*args, "--dumpdir", str(tmp_path / "theirs")])
    ours = _outputs(tmp_path / "ours", "npy")
    _assert_same(ours, _outputs(tmp_path / "theirs", "npy"))
    assert len(ours) == (4 if skip_wav else 8)


@pytest.mark.parametrize("cli", ["preprocess", "compute_statistics",
                                 "normalize", "compute_mcd"])
def test_feature_clis_start_without_torch(cli):
    """Stage 1 of the recipe starts these CLIs one process after another,
    so they import neither torch nor scipy.signal (seconds a process)."""
    out = subprocess.run(
        [sys.executable, "-c", f"import sys, articulatory_tpu_torch.bin.{cli}; "
         "print('torch' in sys.modules, 'scipy.signal' in sys.modules)"],
        capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]
