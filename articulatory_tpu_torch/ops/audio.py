"""Host-side audio utilities, numpy and scipy only (port of
``articulatory_tpu/ops/audio.py``): ``trim_silence`` as
``librosa.effects.trim`` and ``resample`` by polyphase filtering as
``scipy.signal.resample_poly``. scipy is imported where it is used."""

from __future__ import annotations

import math

import numpy as np


def _rms_frames(y: np.ndarray, frame_length: int, hop_length: int
                ) -> np.ndarray:
    """Centered RMS per frame (``librosa.feature.rms``)."""
    pad = frame_length // 2
    yp = np.pad(y.astype(np.float64), (pad, pad))
    n_frames = 1 + (len(yp) - frame_length) // hop_length
    idx = (np.arange(frame_length)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    return np.sqrt(np.mean(yp[idx] ** 2, axis=1))


def trim_silence(audio: np.ndarray, top_db: float = 60.0,
                 frame_length: int = 2048, hop_length: int = 512
                 ) -> tuple[np.ndarray, tuple[int, int]]:
    """Cut leading and trailing frames more than ``top_db`` below the
    loudest; returns the trimmed audio and its ``(start, end)`` samples."""
    rms = _rms_frames(audio, frame_length, hop_length)
    power_db = 20.0 * np.log10(np.maximum(rms, 1e-10))
    nz = np.flatnonzero(power_db > (power_db.max() - top_db))
    if len(nz) == 0:
        return audio[:0], (0, 0)
    start = int(nz[0] * hop_length)
    end = int(min(len(audio), (nz[-1] + 1) * hop_length))
    return audio[start:end], (start, end)


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling from ``orig_sr`` to ``target_sr``."""
    import scipy.signal

    g = math.gcd(int(orig_sr), int(target_sr))
    return scipy.signal.resample_poly(audio, target_sr // g, orig_sr // g)
