"""STFT for the training losses (port of ``articulatory_tpu/ops/stft.py``).

``torch.stft(center=True, pad_mode='reflect')`` numerics, written out so the
window and framing are exactly the JAX package's: reflect-pad ``n_fft // 2``
on each side, periodic Hann window of ``win_length`` zero-padded centred to
``n_fft`` (built in f64, cast once to the input's dtype), ``1 + T // hop``
frames, one-sided rFFT. ``stft_magnitude`` clamps the power at ``eps``
before the square root, as the reference's losses do.

The window (``padded_window``) and the host log-mel of feature extraction
and MCD (``logmelfilterbank_np``) live in the numpy-only ``ops/mel.py``, so
that the feature-extraction CLIs start without importing torch.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from articulatory_tpu_torch.ops.mel import padded_window


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
