#!/usr/bin/env python3
"""Generate a synthetic speech-like EMA-to-wave corpus in MNGU0 layout (port
of ``tools/make_synth_corpus.py``: numpy, ``scipy.signal.lfilter``, the
port's ``ops/mel.py`` and ``utils/io.py``; the same corpus for a seed).

A reproducible stand-in for the MNGU0 corpus of the reference recipe
(egs/ema/voc1, run.sh stage 0 / local/mk_ema_feats.py) for the quality
A/Bs (``articulatory_tpu_torch/tools/*_quality_ab.sh``): the audio is
synthesised here, and the articulatory-style features are derived from the
audio itself (12 log-mel band energies + log-f0 at 200 Hz), so the
feature-to-waveform mapping is learnable and the dev set's MCD measures
generalisation, not memorisation.

Writes:
  <root>/wavs/<utt>.wav             16 kHz PCM
  <root>/feats/<utt>.npy            (T, 13) float32 @ 200 Hz
  <root>/data/{tr,dev}_set/{wav.scp,feats.scp}

Usage:
  python -m articulatory_tpu_torch.tools.make_synth_corpus \\
      --root /tmp/corpus --n-utts 600 [--profile mri]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

SR = 16000
HOP = 80          # 200 Hz frame rate, matching e2w_hifigan.yaml
N_MELS = 12

# --profile mri: the MRI recipe's shapes (egs/mri/voc1/conf/
# mri2w_hifigan_car.yaml: sampling_rate 20000, hop_size 240, generator
# in_channels 358 = 230 feature dims + ar_output 128). Real rtMRI features
# are ~230 correlated vocal-tract pixel intensities at the frame rate; the
# synthetic stand-in derives 40 log-mel bands from the audio and expands
# them through a fixed smooth random linear map to 229 correlated dims
# (+ log-f0), so the feature->waveform mapping stays learnable.
MRI_SR = 20000
MRI_HOP = 240
MRI_MELS = 40
MRI_DIMS = 230


def synth_utterance(rng: np.random.Generator, seconds: float,
                    sr: int = SR) -> np.ndarray:
    """Speech-like signal: glottal-ish harmonic source with a wandering f0,
    a cascade of time-varying formant resonators, amplitude envelope with
    pauses, and unvoiced noise bursts."""
    from scipy.signal import lfilter

    n = int(seconds * sr)
    t = np.arange(n) / sr

    # f0 contour: smoothed random walk in log space, 80-250 Hz
    n_ctrl = max(4, int(seconds * 3))
    ctrl = rng.uniform(np.log(90.0), np.log(230.0), n_ctrl)
    f0 = np.exp(np.interp(np.linspace(0, 1, n), np.linspace(0, 1, n_ctrl), ctrl))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    # harmonic-rich source (soft sawtooth)
    src = np.zeros(n)
    for k in range(1, 12):
        src += np.sin(k * phase) / k
    src /= np.abs(src).max()

    # voicing / syllable envelope: raised-cosine syllable train with pauses
    syl_rate = rng.uniform(2.5, 4.5)
    env = 0.5 * (1 - np.cos(2 * np.pi * syl_rate * t))
    gate = (np.sin(2 * np.pi * rng.uniform(0.3, 0.7) * t
                   + rng.uniform(0, 2 * np.pi)) > -0.7).astype(float)
    env = env * gate

    # unvoiced bursts between syllables
    noise = rng.standard_normal(n) * 0.15
    burst_env = np.clip(np.sin(2 * np.pi * syl_rate * t + np.pi), 0, 1) ** 4
    excitation = src * env + noise * burst_env * gate

    # 3 time-varying formants: split into 50 ms blocks, each a 2-pole resonator
    block = int(0.05 * sr)
    out = np.zeros(n)
    n_blocks = (n + block - 1) // block
    centers = np.stack([
        np.exp(np.interp(np.linspace(0, 1, n_blocks),
                         np.linspace(0, 1, n_ctrl),
                         rng.uniform(np.log(lo), np.log(hi), n_ctrl)))
        for lo, hi in ((300, 900), (900, 2300), (2300, 3500))
    ])
    zi = [np.zeros(2) for _ in range(3)]
    for b in range(n_blocks):
        seg = excitation[b * block:(b + 1) * block]
        acc = np.zeros_like(seg)
        for fi in range(3):
            fc = centers[fi, b]
            bw = 80.0 + 0.06 * fc
            r = np.exp(-np.pi * bw / sr)
            theta = 2 * np.pi * fc / sr
            a = [1.0, -2 * r * np.cos(theta), r * r]
            y, zi[fi] = lfilter([1.0 - r], a, seg, zi=zi[fi])
            acc += y
        out[b * block:(b + 1) * block] = acc

    out = out / (np.abs(out).max() + 1e-9) * 0.6
    return out.astype(np.float32)


def derive_feats(wav: np.ndarray, sr: int = SR, hop: int = HOP,
                 n_mels: int = N_MELS, expand: np.ndarray | None = None
                 ) -> np.ndarray:
    """(T, n_mels+1) features: log-mel band energies + log-f0 proxy;
    with ``expand`` (D, n_mels), mels are mapped to (T, D) correlated
    dims first (MRI-profile pixel-intensity stand-in). Computed from
    the audio so the inverse mapping is learnable."""
    from articulatory_tpu_torch.ops.mel import logmelfilterbank_np

    mel = logmelfilterbank_np(
        wav, sr, fft_size=512 if sr == SR else 1024, hop_size=hop,
        win_length=None, window="hann", num_mels=n_mels, fmin=60,
        fmax=min(7800, sr // 2 - 200))

    # crude autocorrelation f0 proxy per frame (log domain, 0 when unvoiced)
    frame = sr // 40
    n_frames = mel.shape[0]
    pad = np.pad(wav, (0, frame + n_frames * hop - len(wav)), mode="constant")
    f0 = np.zeros(n_frames, np.float32)
    lo, hi = sr // 300, sr // 70
    for i in range(n_frames):
        seg = pad[i * hop:i * hop + frame]
        seg = seg - seg.mean()
        e0 = float(seg @ seg)
        if e0 < 1e-3:
            continue
        ac = np.correlate(seg, seg, "full")[frame - 1:]
        lag = lo + int(np.argmax(ac[lo:hi]))
        if ac[lag] > 0.3 * e0:
            f0[i] = np.log(sr / lag)
    if expand is not None:
        mel = mel @ expand.T          # (T, D) correlated pixel-like dims
    return np.concatenate([mel, f0[:, None]], axis=1).astype(np.float32)


def mri_expansion(seed: int = 1234) -> np.ndarray:
    """Fixed (MRI_DIMS-1, MRI_MELS) smooth random map: each output dim is a
    positive bump over a few neighboring mel bands, like a vocal-tract
    pixel responding to a local articulatory/spectral region."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, MRI_MELS - 1, MRI_DIMS - 1)
    widths = rng.uniform(1.0, 5.0, MRI_DIMS - 1)
    gains = rng.uniform(0.5, 1.5, MRI_DIMS - 1)
    bands = np.arange(MRI_MELS)
    w = np.exp(-0.5 * ((bands[None, :] - centers[:, None]) / widths[:, None]) ** 2)
    w /= w.sum(axis=1, keepdims=True)
    return (gains[:, None] * w).astype(np.float32)


def build_corpus(n_train: int, n_dev: int, seed: int):
    """In-memory learnable corpus of (wav, feats) pairs, the training and
    held-out lists: 2-3.5 s utterances drawn from ``seed`` (the stream of
    ``tools/cotrain_parity.py::build_corpus``)."""
    rng = np.random.default_rng(seed)
    train, dev = [], []
    for i in range(n_train + n_dev):
        wav = synth_utterance(rng, float(rng.uniform(2.0, 3.5)))
        feats = derive_feats(wav)
        (dev if i >= n_train else train).append((wav, feats))
    return train, dev


def sample_batches(corpus, n_steps: int, batch_size: int, win_frames: int,
                   ar_input: int, seed: int, dtype=np.float32):
    """``n_steps`` numpy batches (x (B, win_frames, F), y (B, win_frames x
    HOP, 1), ar (B, ar_input, 1): the wave before the window, zero-padded
    in front), windows drawn from ``seed + 1`` (the stream of
    ``tools/cotrain_parity.py::sample_batches``)."""
    rng = np.random.default_rng(seed + 1)
    batches = []
    for _ in range(n_steps):
        xs, ys, ars = [], [], []
        for _ in range(batch_size):
            wav, feats = corpus[rng.integers(len(corpus))]
            max_f = min(len(feats), len(wav) // HOP) - win_frames
            f0 = int(rng.integers(0, max_f))
            s = f0 * HOP
            xs.append(feats[f0:f0 + win_frames])
            ys.append(wav[s:s + win_frames * HOP, None])
            ar = wav[max(0, s - ar_input):s]
            ars.append(np.pad(ar, (ar_input - len(ar), 0))[:, None])
        batches.append((np.stack(xs).astype(dtype),
                        np.stack(ys).astype(dtype),
                        np.stack(ars).astype(dtype)))
    return batches


def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", required=True)
    p.add_argument("--n-utts", type=int, default=600)
    p.add_argument("--dev-utts", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min-seconds", type=float, default=2.0)
    p.add_argument("--max-seconds", type=float, default=6.0)
    p.add_argument("--profile", choices=["ema", "mri"], default="ema",
                   help="ema: 16 kHz / hop 80 / 13-dim feats "
                        "(e2w_hifigan*.yaml); mri: 20 kHz / hop 240 / "
                        "230-dim feats (mri2w_hifigan_car.yaml)")
    args = p.parse_args(argv)

    from articulatory_tpu_torch.utils.io import write_wav

    if args.profile == "mri":
        sr, hop, n_mels = MRI_SR, MRI_HOP, MRI_MELS
        expand = mri_expansion()
    else:
        sr, hop, n_mels = SR, HOP, N_MELS
        expand = None

    rng = np.random.default_rng(args.seed)
    root = args.root
    os.makedirs(f"{root}/wavs", exist_ok=True)
    os.makedirs(f"{root}/feats", exist_ok=True)
    for name in ("tr", "dev"):
        os.makedirs(f"{root}/data/{name}_set", exist_ok=True)

    entries = {"tr": [], "dev": []}
    for i in range(args.n_utts):
        utt = f"synth{i:04d}"
        seconds = rng.uniform(args.min_seconds, args.max_seconds)
        wav = synth_utterance(rng, seconds, sr=sr)
        write_wav(f"{root}/wavs/{utt}.wav", wav, sr)
        np.save(f"{root}/feats/{utt}.npy",
                derive_feats(wav, sr=sr, hop=hop, n_mels=n_mels,
                             expand=expand))
        entries["dev" if i >= args.n_utts - args.dev_utts else "tr"].append(utt)
        if (i + 1) % 50 == 0:
            print(f"{i + 1}/{args.n_utts}")

    for name, utts in entries.items():
        with open(f"{root}/data/{name}_set/wav.scp", "w") as f:
            for utt in utts:
                f.write(f"{utt} {root}/wavs/{utt}.wav\n")
        with open(f"{root}/data/{name}_set/feats.scp", "w") as f:
            for utt in utts:
                f.write(f"{utt} {root}/feats/{utt}.npy\n")
    print(f"wrote {len(entries['tr'])} train / {len(entries['dev'])} dev to {root}")


if __name__ == "__main__":
    main()
