"""STFT for the training losses (port of ``articulatory_tpu/ops/stft.py``).

``torch.stft(center=True, pad_mode='reflect')`` numerics, written out so the
window and framing are exactly the JAX package's: reflect-pad ``n_fft // 2``
on each side, periodic Hann window of ``win_length`` zero-padded centred to
``n_fft`` (built in f64, cast once to the input's dtype), ``1 + T // hop``
frames, one-sided rFFT. ``stft_magnitude`` clamps the power at ``eps``
before the square root, as the reference's losses do.

``logmelfilterbank_np`` is the host (numpy, float64) log-mel of feature
extraction and MCD: librosa's centred STFT magnitude, the mel matmul, a
clamp at ``eps`` and the log.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from articulatory_tpu_torch.ops.mel import mel_filterbank


def periodic_hann(win_length: int) -> np.ndarray:
    """Periodic Hann window (``torch.hann_window``), float64."""
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def padded_window(window: str, win_length: int, n_fft: int) -> np.ndarray:
    """The ``win_length`` window zero-padded centred to ``n_fft``, float64."""
    if window not in ("hann", "hann_window"):
        raise ValueError(f"Unsupported window: {window}")
    w = periodic_hann(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = np.pad(w, (lpad, n_fft - win_length - lpad))
    return w


@functools.cache
def _window(window: str, win_length: int, n_fft: int, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """The padded window on the signal's device, made once per call site
    (a host-to-device copy per call would stall the host)."""
    return torch.as_tensor(padded_window(window, win_length, n_fft),
                           device=device).to(dtype)


def stft(x: torch.Tensor, *, n_fft: int, hop: int,
         win_length: int | None = None, window: str = "hann",
         center: bool = True) -> torch.Tensor:
    """Complex STFT ``(B, T) -> (B, n_frames, n_fft // 2 + 1)``."""
    w = _window(window, win_length or n_fft, n_fft, x.device, x.dtype)
    if center:
        pad = n_fft // 2
        x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)  # (B, n_frames, n_fft)
    return torch.fft.rfft(frames * w, dim=-1)


def stft_magnitude(x: torch.Tensor, *, n_fft: int, hop: int,
                   win_length: int | None = None, window: str = "hann",
                   center: bool = True, eps: float = 1e-7) -> torch.Tensor:
    """``sqrt(clamp(re^2 + im^2, min=eps))`` of the STFT."""
    z = stft(x, n_fft=n_fft, hop=hop, win_length=win_length, window=window,
             center=center)
    return torch.sqrt(torch.clamp(z.real ** 2 + z.imag ** 2, min=eps))


def logmelfilterbank_np(audio: np.ndarray, sampling_rate: int, *,
                        fft_size: int = 1024, hop_size: int = 256,
                        win_length: int | None = None, window: str = "hann",
                        num_mels: int = 80, fmin: float | None = None,
                        fmax: float | None = None, eps: float = 1e-10,
                        log_base: float | None = 10.0) -> np.ndarray:
    """Log-mel ``(n_frames, num_mels)`` float32 of a 1-D wave, accumulated in
    float64 (``log_base`` 10, 2 or None for the natural log)."""
    w = padded_window(window, win_length or fft_size, fft_size)
    pad = fft_size // 2
    x = np.pad(audio.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = (len(x) - fft_size) // hop_size + 1
    idx = np.arange(fft_size)[None, :] + hop_size * np.arange(n_frames)[:, None]
    spc = np.abs(np.fft.rfft(x[idx] * w, axis=-1))  # (frames, bins)
    fmin = 0 if fmin is None else fmin
    fmax = sampling_rate / 2 if fmax is None else fmax
    mel_basis = mel_filterbank(sampling_rate, fft_size, num_mels, fmin, fmax,
                               dtype=np.float64)
    mel = np.maximum(eps, spc @ mel_basis.T)
    logs = {None: np.log, 10.0: np.log10, 2.0: np.log2}
    if log_base not in logs:
        raise ValueError(f"log_base {log_base} is not supported.")
    return logs[log_base](mel).astype(np.float32)
