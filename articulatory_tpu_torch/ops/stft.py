"""STFT for the training losses (port of ``articulatory_tpu/ops/stft.py``).

``torch.stft(center=True, pad_mode='reflect')`` numerics, written out so the
window and framing are exactly the JAX package's: reflect-pad ``n_fft // 2``
on each side, periodic Hann window of ``win_length`` zero-padded centred to
``n_fft`` (built in f64, cast once to the input's dtype), ``1 + T // hop``
frames, one-sided rFFT. ``stft_magnitude`` clamps the power at ``eps``
before the square root, as the reference's losses do. ``frame_signal`` is
the framing alone, ``(..., T) -> (..., n_frames, frame_length)``, and
``logmelfilterbank`` the feature extractor's log-mel on tensors
(``(..., T) -> (..., n_frames, num_mels)``, on the signal's device): the
amplitude STFT, the float32 mel basis of ``ops/mel.py::mel_filterbank``
cast to the signal's dtype, a floor at ``eps``, then the log.

The window (``padded_window``) and the host log-mel of feature extraction
and MCD (``logmelfilterbank_np``) live in the numpy-only ``ops/mel.py``, so
that the feature-extraction CLIs start without importing torch.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from articulatory_tpu_torch.ops.mel import mel_filterbank, padded_window


@functools.cache
def _window(window: str, win_length: int, n_fft: int, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """The padded window on the signal's device, made once per call site
    (a host-to-device copy per call would stall the host)."""
    return torch.as_tensor(padded_window(window, win_length, n_fft),
                           device=device).to(dtype)


@functools.cache
def _mel_basis(sr: float, n_fft: int, num_mels: int, fmin: float,
               fmax: float, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """``(1 + n_fft // 2, num_mels)`` on the signal's device, made once."""
    return torch.as_tensor(mel_filterbank(sr, n_fft, num_mels, fmin, fmax).T,
                           device=device).to(dtype)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int
                 ) -> torch.Tensor:
    """Overlapping frames ``(..., T) -> (..., (T - frame_length) // hop + 1,
    frame_length)``, a strided view of ``x``."""
    return x.unfold(-1, frame_length, hop)


def stft(x: torch.Tensor, *, n_fft: int, hop: int,
         win_length: int | None = None, window: str = "hann",
         center: bool = True) -> torch.Tensor:
    """Complex STFT ``(B, T) -> (B, n_frames, n_fft // 2 + 1)``."""
    w = _window(window, win_length or n_fft, n_fft, x.device, x.dtype)
    if center:
        pad = n_fft // 2
        x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return torch.fft.rfft(frame_signal(x, n_fft, hop) * w, dim=-1)


def stft_magnitude(x: torch.Tensor, *, n_fft: int, hop: int,
                   win_length: int | None = None, window: str = "hann",
                   center: bool = True, eps: float = 1e-7) -> torch.Tensor:
    """``sqrt(clamp(re^2 + im^2, min=eps))`` of the STFT."""
    z = stft(x, n_fft=n_fft, hop=hop, win_length=win_length, window=window,
             center=center)
    return torch.sqrt(torch.clamp(z.real ** 2 + z.imag ** 2, min=eps))


def logmelfilterbank(audio: torch.Tensor, sampling_rate: int, *,
                     fft_size: int = 1024, hop_size: int = 256,
                     win_length: int | None = None, window: str = "hann",
                     num_mels: int = 80, fmin: float | None = None,
                     fmax: float | None = None, eps: float = 1e-10,
                     log_base: float | None = 10.0) -> torch.Tensor:
    """Log-mel features ``(..., T) -> (..., n_frames, num_mels)``
    (``log_base`` 10, 2 or None for the natural log)."""
    logs = {None: torch.log, 10.0: torch.log10, 2.0: torch.log2}
    if log_base not in logs:
        raise ValueError(f"log_base {log_base} is not supported.")
    lead = audio.shape[:-1]
    # |z| with no clamp, as librosa's amplitude spectrum
    spc = stft_magnitude(audio.reshape(-1, audio.shape[-1]), n_fft=fft_size,
                         hop=hop_size, win_length=win_length, window=window,
                         eps=0.0)
    basis = _mel_basis(sampling_rate, fft_size, num_mels,
                       0 if fmin is None else fmin,
                       sampling_rate / 2 if fmax is None else fmax,
                       audio.device, audio.dtype)
    mel = torch.clamp(spc @ basis, min=eps)
    return logs[log_base](mel).reshape(*lead, *mel.shape[-2:])
