"""Pseudo-QMF multiband filterbank (port of ``articulatory_tpu/ops/pqmf.py``).

The filters are the JAX package's, copied: a Kaiser-windowed lowpass
prototype cosine-modulated into per-subband analysis and synthesis filters
with alternating +-pi/4 phase (``design_prototype_filter``,
``pqmf_filterbanks``). Over NLC signals:

- ``analysis``: ``(B, T, 1) -> (B, T // subbands, subbands)``, one strided
  ``F.conv1d`` (filter and decimate), padded ``(taps // 2, taps // 2 -
  (subbands - 1))`` so that a length not divisible by ``subbands`` gives the
  reference's frame count;
- ``synthesis``: ``(B, T', subbands) -> (B, T' * subbands, 1)``, one
  ``F.conv_transpose1d`` (zero-stuffing and the synthesis filter, the
  power compensation ``x subbands`` folded into the filter), the JAX
  package's input-dilated convolution written as a transposed one.

The filters are buffers outside the state dict (rebuilt at construction),
so ``.to(device, dtype)`` moves them with the module that holds them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal.windows import kaiser
from torch import nn


def design_prototype_filter(taps: int = 62, cutoff_ratio: float = 0.142,
                            beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed lowpass prototype, ``(taps + 1,)``."""
    if taps % 2 != 0:
        raise ValueError("The number of taps must be an even number.")
    if not 0.0 < cutoff_ratio < 1.0:
        raise ValueError("Cutoff ratio must be in (0, 1).")
    omega_c = np.pi * cutoff_ratio
    n = np.arange(taps + 1) - 0.5 * taps
    with np.errstate(invalid="ignore"):
        h_i = np.sin(omega_c * n) / (np.pi * n)
    h_i[taps // 2] = cutoff_ratio  # sinc(0) limit
    return h_i * kaiser(taps + 1, beta)


def pqmf_filterbanks(subbands: int = 4, taps: int = 62,
                     cutoff_ratio: float = 0.142, beta: float = 9.0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Cosine-modulated analysis and synthesis banks, each ``(subbands,
    taps + 1)``, float32."""
    h_proto = design_prototype_filter(taps, cutoff_ratio, beta)
    n = np.arange(taps + 1) - taps / 2
    k = np.arange(subbands)[:, None]
    phase = (2 * k + 1) * (np.pi / (2 * subbands)) * n[None, :]
    sign = ((-1.0) ** np.arange(subbands))[:, None]
    h_analysis = 2 * h_proto[None, :] * np.cos(phase + sign * np.pi / 4)
    h_synthesis = 2 * h_proto[None, :] * np.cos(phase - sign * np.pi / 4)
    return h_analysis.astype(np.float32), h_synthesis.astype(np.float32)


class PQMF(nn.Module):
    def __init__(self, subbands: int = 4, taps: int = 62,
                 cutoff_ratio: float = 0.142, beta: float = 9.0):
        super().__init__()
        self.subbands, self.taps = subbands, taps
        h_analysis, h_synthesis = pqmf_filterbanks(subbands, taps,
                                                   cutoff_ratio, beta)
        # F.conv1d weight (subbands, 1, K); F.conv_transpose1d weight
        # (subbands, 1, K), time-flipped: the JAX package's cross-correlation
        # over the zero-stuffed signal is a transposed conv with the flip
        self.register_buffer("analysis_filter",
                             torch.from_numpy(h_analysis[:, None, :]),
                             persistent=False)
        self.register_buffer(
            "synthesis_filter",
            torch.from_numpy(np.ascontiguousarray(
                h_synthesis[:, None, ::-1] * subbands)), persistent=False)

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, 1) -> (B, T // subbands, subbands)``."""
        pad = self.taps // 2
        xc = F.pad(x.transpose(1, 2), (pad, pad - (self.subbands - 1)))
        y = F.conv1d(xc, self.analysis_filter.to(x.dtype),
                     stride=self.subbands)
        return y.transpose(1, 2)

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T', subbands) -> (B, T' * subbands, 1)``."""
        y = F.conv_transpose1d(x.transpose(1, 2),
                               self.synthesis_filter.to(x.dtype),
                               stride=self.subbands, padding=self.taps // 2,
                               output_padding=self.subbands - 1)
        return y.transpose(1, 2)
