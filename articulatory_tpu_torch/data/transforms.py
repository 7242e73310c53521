"""Named preprocessing transforms resolved from YAML by name (the port's
copy of ``articulatory_tpu/data/transforms.py``).

Parity target: reference articulatory/transforms/transforms.py (EMG
notch/drift/subsample chain, 16->22.05 kHz resample). resampy is replaced by
scipy polyphase resampling. Host-side numpy and scipy (``scipy.signal``
imported where it is used: it takes seconds to import, and every CLI
imports this module).
"""

from __future__ import annotations

import numpy as np


def remove_drift(signal: np.ndarray, fs: float) -> np.ndarray:
    import scipy.signal

    b, a = scipy.signal.butter(3, 2, "highpass", fs=fs)
    return scipy.signal.filtfilt(b, a, signal)


def notch(signal: np.ndarray, freq: float, sample_frequency: float) -> np.ndarray:
    import scipy.signal

    b, a = scipy.signal.iirnotch(freq, 30, sample_frequency)
    return scipy.signal.filtfilt(b, a, signal)


def notch_harmonics(signal: np.ndarray, freq: float, sample_frequency: float
                    ) -> np.ndarray:
    for harmonic in range(1, 8):
        signal = notch(signal, freq * harmonic, sample_frequency)
    return signal


def subsample(signal: np.ndarray, new_freq: float, old_freq: float) -> np.ndarray:
    times = np.arange(len(signal)) / old_freq
    sample_times = np.arange(0, times[-1], 1 / new_freq)
    return np.interp(sample_times, times, signal)


def apply_to_all(function, signal_array: np.ndarray, *args, **kwargs) -> np.ndarray:
    results = [function(signal_array[:, i], *args, **kwargs)
               for i in range(signal_array.shape[1])]
    return np.stack(results, 1)


def preprocess_emg(x: np.ndarray) -> np.ndarray:
    """EMG chain: notch 60 Hz harmonics -> drift removal -> 689.06 Hz subsample."""
    x = apply_to_all(notch_harmonics, x, 60, 1000)
    x = apply_to_all(remove_drift, x, 1000)
    x = apply_to_all(subsample, x, 689.06, 1000)
    return x


def resample_16_22(x: np.ndarray) -> np.ndarray:
    """16 kHz -> 22.05 kHz polyphase resample, clipped to [-1, 1]."""
    import scipy.signal

    x = scipy.signal.resample_poly(x, 441, 320)
    return np.clip(x, -1, 1)


def scale_10_f0(art: np.ndarray) -> np.ndarray:
    """Scale channel 0 (log-f0) by 10.

    The reference passes the raw ``transform: "10*f0"`` YAML string to its
    art datasets and string-compares it (reference
    articulatory/datasets/audio_mel_dataset.py:280-281, 644-645, 961-962);
    here it resolves to a callable like every other transform.
    """
    art = np.asarray(art).copy()
    art[:, 0] *= 10
    return art


_TRANSFORMS = {
    "preprocess_emg": preprocess_emg,
    "resample_16_22": resample_16_22,
    # the reference's string-hook spelled as a named transform
    "10*f0": scale_10_f0,
}

# Transforms that only make sense on (T, C) articulatory features. When the
# bare ``transform`` key defaults input_transform/output_transform (reference
# train.py:1536-1541), these must never reach the 1-D audio side of
# SpeechDataset — the reference itself cannot apply "10*f0" there (its
# getattr resolution crashes on the string), so art-only application IS the
# reference contract.
ART_ONLY_TRANSFORMS = frozenset({"10*f0"})


def get_transform(name: str):
    """Resolve a transform by name (reference train.py:1536-1541 getattr)."""
    if name is None:
        return None
    if name not in _TRANSFORMS:
        raise KeyError(f"Unknown transform: {name!r}. Known: {sorted(_TRANSFORMS)}")
    return _TRANSFORMS[name]
