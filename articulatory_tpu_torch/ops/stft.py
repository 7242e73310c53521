"""STFT for the training losses (port of ``articulatory_tpu/ops/stft.py``).

``torch.stft(center=True, pad_mode='reflect')`` numerics, written out so the
window and framing are exactly the JAX package's: reflect-pad ``n_fft // 2``
on each side, periodic Hann window of ``win_length`` zero-padded centred to
``n_fft`` (built in f64, cast once to the input's dtype), ``1 + T // hop``
frames, one-sided rFFT. ``stft_magnitude`` clamps the power at ``eps``
before the square root, as the reference's losses do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


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
