"""Multi-resolution STFT loss (port of
``articulatory_tpu/losses/stft_loss.py``): per resolution the spectral
convergence ``||Y - X||_F / ||Y||_F`` and the log-magnitude L1, averaged
over resolutions; (B, T, C) subband signals are flattened to (B*C, T)."""

from __future__ import annotations

from typing import Sequence

import torch

from articulatory_tpu_torch.ops.stft import stft_magnitude


class STFTLoss:
    """Single-resolution STFT loss."""

    def __init__(self, fft_size: int = 1024, shift_size: int = 120,
                 win_length: int = 600, window: str = "hann_window"):
        if window not in ("hann", "hann_window"):
            raise ValueError(f"Unsupported window: {window}")
        self.fft_size = fft_size
        self.shift_size = shift_size
        self.win_length = win_length

    def __call__(self, x: torch.Tensor, y: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """x, y: predicted / groundtruth signals (B, T)."""
        kwargs = dict(n_fft=self.fft_size, hop=self.shift_size,
                      win_length=self.win_length, eps=1e-7)
        x_mag = stft_magnitude(x, **kwargs)
        y_mag = stft_magnitude(y, **kwargs)
        sc_loss = torch.linalg.norm(y_mag - x_mag) / torch.linalg.norm(y_mag)
        mag_loss = torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))
        return sc_loss, mag_loss


class MultiResolutionSTFTLoss:
    """Average of STFT losses at several resolutions."""

    def __init__(self, fft_sizes: Sequence[int] = (1024, 2048, 512),
                 hop_sizes: Sequence[int] = (120, 240, 50),
                 win_lengths: Sequence[int] = (600, 1200, 240),
                 window: str = "hann_window"):
        if not len(fft_sizes) == len(hop_sizes) == len(win_lengths):
            raise ValueError("fft_sizes, hop_sizes and win_lengths differ "
                             "in length")
        self.losses = [STFTLoss(f, s, w, window)
                       for f, s, w in zip(fft_sizes, hop_sizes, win_lengths)]

    def __call__(self, x: torch.Tensor, y: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """x, y: (B, T) or (B, T, C); returns (sc_loss, mag_loss)."""
        if x.dim() == 3:  # (B, T, C) -> (B*C, T), the reference's flatten
            x = x.transpose(1, 2).reshape(-1, x.shape[1])
            y = y.transpose(1, 2).reshape(-1, y.shape[1])
        sc_loss = mag_loss = 0.0
        for f in self.losses:
            sc, mag = f(x, y)
            sc_loss = sc_loss + sc
            mag_loss = mag_loss + mag
        return sc_loss / len(self.losses), mag_loss / len(self.losses)
