"""Mel-cepstral distortion (port of ``articulatory_tpu/eval/mcd.py``):
mel cepstra from the natural-log mel spectrogram by the orthonormal DCT-II
(coefficients 1..K, energy excluded), frames aligned by truncation or DTW,
and

    MCD = (10 * sqrt(2) / ln 10) * mean_t ||mc_a(t) - mc_b(t)||_2 .
"""

from __future__ import annotations

import numpy as np
import scipy.fft

from articulatory_tpu_torch.ops.mel import logmelfilterbank_np

MCD_CONST = 10.0 * np.sqrt(2.0) / np.log(10.0)


def mel_cepstra(audio: np.ndarray, sr: int, n_mfcc: int = 13,
                fft_size: int = 1024, hop_size: int = 256,
                num_mels: int = 80) -> np.ndarray:
    """Mel cepstra (T, n_mfcc), c0 included."""
    logmel = logmelfilterbank_np(audio, sr, fft_size=fft_size,
                                 hop_size=hop_size, num_mels=num_mels,
                                 fmin=0, fmax=sr / 2, log_base=None)
    return scipy.fft.dct(logmel, axis=1, type=2, norm="ortho")[:, :n_mfcc]


def _dtw_path(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW alignment of two frame sequences (euclidean local
    cost). The accumulated cost is filled one anti-diagonal at a time (each
    cell needs only the two diagonals before it, and the sums are the
    cell-by-cell ones); the backtrack takes the cheapest of the diagonal,
    upper and left predecessors, ties to the smaller (i, j)."""
    ta, tb = len(a), len(b)
    dist = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
    acc = np.full((ta, tb), np.inf)
    acc[0, 0] = dist[0, 0]
    for k in range(1, ta + tb - 1):
        i = np.arange(max(0, k - tb + 1), min(k, ta - 1) + 1)
        j = k - i
        best = np.full(len(i), np.inf)
        up, left, diag = i > 0, j > 0, (i > 0) & (j > 0)
        best[up] = np.minimum(best[up], acc[i[up] - 1, j[up]])
        best[left] = np.minimum(best[left], acc[i[left], j[left] - 1])
        best[diag] = np.minimum(best[diag], acc[i[diag] - 1, j[diag] - 1])
        acc[i, j] = dist[i, j] + best
    path_a, path_b = [ta - 1], [tb - 1]
    i, j = ta - 1, tb - 1
    while i > 0 or j > 0:
        candidates = []
        if i > 0 and j > 0:
            candidates.append((acc[i - 1, j - 1], i - 1, j - 1))
        if i > 0:
            candidates.append((acc[i - 1, j], i - 1, j))
        if j > 0:
            candidates.append((acc[i, j - 1], i, j - 1))
        _, i, j = min(candidates)
        path_a.append(i)
        path_b.append(j)
    return np.asarray(path_a[::-1]), np.asarray(path_b[::-1])


def mel_cepstral_distortion(audio_a: np.ndarray, audio_b: np.ndarray, sr: int,
                            n_mfcc: int = 13, use_dtw: bool = False,
                            fft_size: int = 1024, hop_size: int = 256) -> float:
    """MCD in dB between two waveforms (c0 excluded)."""
    mc_a = mel_cepstra(audio_a, sr, n_mfcc=n_mfcc, fft_size=fft_size,
                       hop_size=hop_size)[:, 1:]
    mc_b = mel_cepstra(audio_b, sr, n_mfcc=n_mfcc, fft_size=fft_size,
                       hop_size=hop_size)[:, 1:]
    if use_dtw:
        pa, pb = _dtw_path(mc_a, mc_b)
        mc_a, mc_b = mc_a[pa], mc_b[pb]
    else:
        t = min(len(mc_a), len(mc_b))
        mc_a, mc_b = mc_a[:t], mc_b[:t]
    return float(MCD_CONST * np.mean(
        np.sqrt(((mc_a - mc_b) ** 2).sum(axis=1))))
