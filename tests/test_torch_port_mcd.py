"""The port's MCD (``eval/mcd.py``, ``bin/compute_mcd.py``) against the JAX
package's: mel cepstra, the DTW path on frames with ties (the vectorised
fill keeps the backtrack's order), and MCD with and without DTW, at rtol
1e-6; the CLI on two small directories."""

import sys

import numpy as np
import pytest
import torch

from articulatory_tpu.bin import compute_mcd as jax_cli
from articulatory_tpu.eval import mcd as jax_mcd
from articulatory_tpu_torch.bin import compute_mcd
from articulatory_tpu_torch.eval import mcd
from articulatory_tpu_torch.utils.io import write_wav

torch.set_num_threads(1)

SR = 16000


def _waves(seed, n=6000, shift=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    a = (0.3 * np.sin(2 * np.pi * 220 * t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    b = np.concatenate([np.zeros(shift, np.float32), a])[:n - 700]
    b = b + 0.02 * rng.standard_normal(len(b)).astype(np.float32)
    return a, b


def test_mel_cepstra_matches_jax():
    a, _ = _waves(0)
    np.testing.assert_allclose(mcd.mel_cepstra(a, SR, n_mfcc=20),
                               jax_mcd.mel_cepstra(a, SR, n_mfcc=20),
                               rtol=1e-6)


@pytest.mark.parametrize("ta,tb,values", [(1, 1, 3), (1, 6, 2), (6, 1, 2),
                                          (9, 12, 2), (17, 11, 3),
                                          (25, 25, 1)])
def test_dtw_path_with_ties_matches_jax(ta, tb, values):
    """Small integer frames, repeated: many equal accumulated costs."""
    rng = np.random.default_rng(ta * 100 + tb)
    a = rng.integers(0, values, (ta, 3)).astype(np.float64)
    b = np.repeat(a, 2, axis=0)[:tb] if tb > ta else a[::2][:tb].copy()
    b = np.concatenate([b, rng.integers(0, values, (tb - len(b), 3))])
    ours, theirs = mcd._dtw_path(a, b), jax_mcd._dtw_path(a, b)
    for o, t in zip(ours, theirs):
        np.testing.assert_array_equal(o, t)


@pytest.mark.parametrize("use_dtw", [False, True])
def test_mcd_matches_jax(use_dtw):
    a, b = _waves(1, shift=240)
    ours = mcd.mel_cepstral_distortion(a, b, SR, use_dtw=use_dtw)
    theirs = jax_mcd.mel_cepstral_distortion(a, b, SR, use_dtw=use_dtw)
    assert ours > 0.5
    np.testing.assert_allclose(ours, theirs, rtol=1e-6)
    assert mcd.mel_cepstral_distortion(a, a, SR, use_dtw=use_dtw) == 0.0


@pytest.mark.parametrize("dtw", [False, True])
def test_compute_mcd_cli_matches_jax(tmp_path, monkeypatch, capsys, dtw):
    gen, ref = tmp_path / "gen", tmp_path / "ref"
    for i in range(3):
        a, b = _waves(10 + i, n=4000 + 800 * i, shift=80 * i)
        write_wav(str(gen / f"u{i}_gen.wav"), b, SR)
        write_wav(str(ref / f"u{i}.wav"), a, SR)
    write_wav(str(ref / "only_ref.wav"), a, SR)  # unpaired: left out
    flags = ["--dtw"] if dtw else []
    compute_mcd.main(["--gen-dir", str(gen), "--ref-dir", str(ref), *flags])
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["prog", "--gen-dir", str(gen),
                                      "--ref-dir", str(ref), *flags])
    jax_cli.main()
    assert ours == capsys.readouterr().out
    assert ours.count("\n") == 4 and "mean MCD over 3 utterances" in ours
    with pytest.raises(ValueError, match="no overlapping"):
        compute_mcd.compute_mcd(str(gen), str(tmp_path))
