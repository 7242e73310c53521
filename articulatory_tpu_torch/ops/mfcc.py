"""MFCC extraction on the host, librosa-compatible (port of
``articulatory_tpu/ops/mfcc.py``, numpy and scipy only).

Power mel spectrogram (|STFT|^2 @ mel, reflect-padded centred frames of a
periodic Hann window) -> ``power_to_db`` (ref 1.0, ``top_db`` 80 below the
maximum) -> orthonormal DCT-II over the mel axis -> the first ``n_mfcc``
coefficients. The inversion entry point (``bin/predict_ema.py``) computes
its 13-d features with it.
"""

from __future__ import annotations

import numpy as np
import scipy.fft

from articulatory_tpu_torch.ops.mel import mel_filterbank, padded_window


def melspectrogram_np(y: np.ndarray, sr: int, n_fft: int = 2048,
                      hop_length: int = 512, win_length: int | None = None,
                      n_mels: int = 128, fmin: float = 0.0,
                      fmax: float | None = None, power: float = 2.0
                      ) -> np.ndarray:
    """Power mel spectrogram ``(n_mels, n_frames)``, float64."""
    w = padded_window("hann", win_length or n_fft, n_fft)
    pad = n_fft // 2
    x = np.pad(np.asarray(y, np.float64), (pad, pad), mode="reflect")
    n_frames = (len(x) - n_fft) // hop_length + 1
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    spec = np.abs(np.fft.rfft(x[idx] * w, axis=-1)) ** power  # (frames, bins)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, dtype=np.float64)
    return (spec @ fb.T).T


def power_to_db(s: np.ndarray, ref: float = 1.0, amin: float = 1e-10,
                top_db: float | None = 80.0) -> np.ndarray:
    log_spec = 10.0 * np.log10(np.maximum(amin, s))
    log_spec -= 10.0 * np.log10(np.maximum(amin, ref))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def mfcc_np(y: np.ndarray, sr: int, n_mfcc: int = 20, n_fft: int = 2048,
            hop_length: int = 512, n_mels: int = 128) -> np.ndarray:
    """MFCCs ``(n_mfcc, n_frames)``, as ``librosa.feature.mfcc``."""
    s = power_to_db(melspectrogram_np(y, sr, n_fft=n_fft,
                                      hop_length=hop_length, n_mels=n_mels))
    return scipy.fft.dct(s, axis=0, type=2, norm="ortho")[:n_mfcc]
