"""Linear time interpolation over NLC ``(B, T, C)`` tensors (port of
``articulatory_tpu/ops/interp.py``): ``torch.nn.functional.interpolate``'s
``mode='linear', align_corners=False`` mapping, with the JAX package's
arithmetic. The source positions are computed in float32 whatever the
input's dtype (a float64 input keeps float32 positions and weights, as in
JAX), and the size ratio is ``t_in / size``; ``F.interpolate`` takes
``1 / scale_factor`` on its scale path and can differ in the last ulp.
Each position ``(i + 0.5) * ratio - 0.5`` is rounded once, as XLA compiles
that formula (a fused multiply-add) in every jitted program of the JAX
package; JAX run op by op rounds the product too, which moves a position
by up to an ulp of float32 where the ratio is inexact.
"""

from __future__ import annotations

import torch


def interpolate_linear(x: torch.Tensor, size: int) -> torch.Tensor:
    """x ``(B, T, C)`` -> ``(B, size, C)``."""
    t_in = x.shape[1]
    ratio = torch.tensor(t_in / size, dtype=torch.float32, device=x.device)
    # torch's half-pixel mapping; the float64 product of two float32s and
    # its difference with 0.5 are exact, so one rounding to float32 is the
    # fused multiply-add's
    half = torch.arange(size, dtype=torch.float32, device=x.device) + 0.5
    pos = (half.double() * ratio.double() - 0.5).float()
    pos = pos.clamp(0.0, t_in - 1)
    lo = pos.floor().to(torch.long)
    hi = (lo + 1).clamp(max=t_in - 1)
    w = (pos - lo)[None, :, None]
    return x[:, lo, :] * (1.0 - w) + x[:, hi, :] * w


def interpolate_linear_scale(x: torch.Tensor, scale_factor: float
                             ) -> torch.Tensor:
    """``F.interpolate(scale_factor=...)``'s output length, ``floor(T *
    scale)``, through ``interpolate_linear``."""
    return interpolate_linear(x, int(x.shape[1] * scale_factor))
