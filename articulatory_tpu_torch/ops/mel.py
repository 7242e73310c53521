"""Mel filterbank design, numerically compatible with librosa's (slaney
flavor): the port's own copy of ``articulatory_tpu/ops/mel.py`` (numpy only).

``mel_filterbank(sr, n_fft, n_mels, fmin, fmax)`` is librosa's old
positional ``filters.mel`` (``htk=False``, ``norm='slaney'``). A fixed
matrix, designed once on the host; an ``fmax`` above Nyquist (the e2w mel
loss's 11025 at 16 kHz) is taken as given, as librosa and the JAX package
do: the top filters then reach past the last FFT bin.
"""

from __future__ import annotations

import numpy as np


def hz_to_mel(frequencies, htk: bool = False):
    """Convert Hz to mel (slaney by default, matching librosa)."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + frequencies / 700.0)
    # Slaney formula: linear below 1 kHz, log above.
    f_min = 0.0
    f_sp = 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if frequencies.ndim:
        log_t = frequencies >= min_log_hz
        mels[log_t] = min_log_mel + np.log(frequencies[log_t] / min_log_hz) / logstep
    elif frequencies >= min_log_hz:
        mels = min_log_mel + np.log(frequencies / min_log_hz) / logstep
    return mels


def mel_to_hz(mels, htk: bool = False):
    """Convert mel to Hz (slaney by default, matching librosa)."""
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min = 0.0
    f_sp = 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = mels >= min_log_mel
        freqs[log_t] = min_log_hz * np.exp(logstep * (mels[log_t] - min_log_mel))
    elif mels >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float, htk: bool = False):
    mels = np.linspace(hz_to_mel(fmin, htk=htk), hz_to_mel(fmax, htk=htk), n_mels)
    return mel_to_hz(mels, htk=htk)


def fft_frequencies(sr: float, n_fft: int):
    return np.linspace(0.0, float(sr) / 2, 1 + n_fft // 2)


def mel_filterbank(sr: float, n_fft: int, n_mels: int = 128,
                   fmin: float = 0.0, fmax: float | None = None,
                   htk: bool = False, norm: str | None = "slaney",
                   dtype=np.float32) -> np.ndarray:
    """Triangular mel filterbank ``(n_mels, 1 + n_fft // 2)``, librosa-compatible."""
    if fmax is None:
        fmax = float(sr) / 2
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk=htk)

    fdiff = np.diff(mel_f)
    ramps = np.subtract.outer(mel_f, fftfreqs)

    weights = np.zeros((n_mels, 1 + n_fft // 2), dtype=np.float64)
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, np.newaxis]
    elif norm is not None:
        raise ValueError(f"Unsupported norm={norm}")
    return weights.astype(dtype)
