"""Mel-spectrogram L1 loss (port of ``articulatory_tpu/losses/mel_loss.py``).

The slaney mel matrix is designed once on the host in float32, as the JAX
package closes over it, and cast to the signal's dtype; the STFT follows
``torch.stft`` (centred, reflect pad) with the power clamped at ``eps``
before the square root.
"""

from __future__ import annotations

import torch

from articulatory_tpu_torch.ops.mel import mel_filterbank
from articulatory_tpu_torch.ops.stft import stft


class MelSpectrogram:
    """Log-mel spectrogram ``(B, T) -> (B, #frames, num_mels)``."""

    def __init__(self, fs: int = 22050, fft_size: int = 1024,
                 hop_size: int = 256, win_length: int | None = None,
                 window: str = "hann", num_mels: int = 80,
                 fmin: float | None = 80, fmax: float | None = 7600,
                 center: bool = True, normalized: bool = False,
                 onesided: bool = True, eps: float = 1e-10,
                 log_base: float | None = 10.0):
        if normalized or not onesided:
            raise ValueError("only normalized=False, onesided=True")
        if log_base not in (None, 2.0, 10.0):
            raise ValueError(f"log_base: {log_base} is not supported.")
        self.fft_size = fft_size
        self.hop_size = hop_size
        self.win_length = fft_size if win_length is None else win_length
        self.window = window
        self.center = center
        self.eps = eps
        self.log_base = log_base
        fmin = 0 if fmin is None else fmin
        fmax = fs / 2 if fmax is None else fmax
        self.melmat = torch.from_numpy(
            mel_filterbank(fs, fft_size, num_mels, fmin, fmax).T.copy())
        self._on_device: dict = {}  # (device, dtype) -> melmat there

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:  # (B, T, C) -> (B*C, T)
            x = x.transpose(1, 2).reshape(-1, x.shape[1])
        z = stft(x, n_fft=self.fft_size, hop=self.hop_size,
                 win_length=self.win_length, window=self.window,
                 center=self.center)
        amp = torch.sqrt(torch.clamp(z.real ** 2 + z.imag ** 2, min=self.eps))
        key = (amp.device, amp.dtype)
        if key not in self._on_device:
            self._on_device[key] = self.melmat.to(amp)
        mel = torch.clamp(amp @ self._on_device[key], min=self.eps)
        if self.log_base is None:
            return torch.log(mel)
        if self.log_base == 10.0:
            return torch.log10(mel)
        return torch.log2(mel)


class MelSpectrogramLoss:
    """L1 between generated and groundtruth log-mels."""

    def __init__(self, **kwargs):
        self.mel_spectrogram = MelSpectrogram(**kwargs)

    def __call__(self, y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """y_hat, y: (B, T) or (B, T, C) waveforms."""
        return torch.mean(torch.abs(self.mel_spectrogram(y_hat)
                                    - self.mel_spectrogram(y)))
