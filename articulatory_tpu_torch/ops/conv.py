"""1-D convolutions with exact PyTorch semantics over NLC ``(B, T, C)`` input.

The port keeps the JAX package's layouts at these functions, so a test hands
both packages the same arrays:

- ``conv1d`` weight: ``(K, C_in // groups, C_out)``;
- ``conv_transpose1d`` weight: ``(K, C_in, C_out)``, time-flipped relative to
  torch's ``(C_in, C_out, K)`` (``w[k, i, o] = w_torch[i, o, K-1-k]``).

They run on ``F.conv1d`` / ``F.conv_transpose1d``. The JAX package's MXU
rewrites (tap-stacked matmuls, densified grouped kernels) are exact
equivalences of a plain convolution and are not carried over.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d_output_length(length: int, kernel_size: int, stride: int = 1,
                         padding: int = 0, dilation: int = 1) -> int:
    """PyTorch Conv1d output length."""
    return (length + 2 * padding - dilation * (kernel_size - 1) - 1) // stride + 1


def conv_transpose1d_output_length(length: int, kernel_size: int, stride: int = 1,
                                   padding: int = 0, output_padding: int = 0,
                                   dilation: int = 1) -> int:
    """PyTorch ConvTranspose1d output length."""
    return ((length - 1) * stride - 2 * padding + dilation * (kernel_size - 1)
            + 1 + output_padding)


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: int = 1, padding: int | tuple[int, int] = 0,
           dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """x ``(B, T, C_in)``, w ``(K, C_in // groups, C_out)``, b ``(C_out,)``;
    padding is symmetric or an explicit ``(lo, hi)`` pair.
    Returns ``(B, T_out, C_out)``."""
    xc = x.transpose(1, 2)
    if not isinstance(padding, int):
        lo, hi = padding
        if lo == hi:
            padding = lo
        else:
            xc = F.pad(xc, (lo, hi))
            padding = 0
    y = F.conv1d(xc, w.permute(2, 1, 0), b, stride=stride, padding=padding,
                 dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, *, stride: int = 1,
                     padding: int = 0, output_padding: int = 0,
                     dilation: int = 1) -> torch.Tensor:
    """x ``(B, T, C_in)``, pre-flipped w ``(K, C_in, C_out)``, b ``(C_out,)``.
    Returns ``(B, (T-1)*stride - 2*padding + dilation*(K-1) + 1
    + output_padding, C_out)``, as ``torch.nn.ConvTranspose1d``."""
    y = F.conv_transpose1d(x.transpose(1, 2), w.permute(1, 2, 0).flip(-1), b,
                           stride=stride, padding=padding,
                           output_padding=output_padding, dilation=dilation)
    return y.transpose(1, 2)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)
