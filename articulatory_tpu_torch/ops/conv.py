"""1-D convolutions with exact PyTorch semantics over NLC ``(B, T, C)`` input.

The port keeps the JAX package's layouts at these functions, so a test hands
both packages the same arrays:

- ``conv1d`` weight: ``(K, C_in // groups, C_out)``;
- ``conv_transpose1d`` weight: ``(K, C_in, C_out)``, time-flipped relative to
  torch's ``(C_in, C_out, K)`` (``w[k, i, o] = w_torch[i, o, K-1-k]``);
- ``conv2d`` over NHWC ``(B, H, W, C)``, weight ``(Kh, Kw, C_in // groups,
  C_out)``.

``avg_pool1d`` is ``torch.nn.AvgPool1d`` over the time axis of NLC input
(port of ``articulatory_tpu/models/melgan.py::avg_pool1d``).

They run on ``F.conv1d`` / ``F.conv_transpose1d`` / ``F.conv2d``. The JAX package's MXU
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
    wt = w.permute(2, 1, 0)
    if wt.device.type == "cpu":
        # the CPU backward refuses a strided weight for some shapes
        wt = wt.contiguous()
    y = F.conv1d(xc, wt, b, stride=stride, padding=padding,
                 dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, *, stride: int = 1,
                     padding: int = 0, output_padding: int = 0,
                     dilation: int = 1) -> torch.Tensor:
    """x ``(B, T, C_in)``, pre-flipped w ``(K, C_in, C_out)``, b ``(C_out,)``.
    Returns ``(B, (T-1)*stride - 2*padding + dilation*(K-1) + 1
    + output_padding, C_out)``, as ``torch.nn.ConvTranspose1d``. An
    ``output_padding`` of at least both stride and dilation, which torch
    refuses and the JAX package computes (a stride-1 upsampling, scale 1,
    pads by 1), is the full transposed convolution cropped as torch's
    definition crops it."""
    xc, wt = x.transpose(1, 2), w.permute(1, 2, 0).flip(-1)
    if output_padding < max(stride, dilation):
        y = F.conv_transpose1d(xc, wt, b, stride=stride, padding=padding,
                               output_padding=output_padding,
                               dilation=dilation)
        return y.transpose(1, 2)
    y = F.conv_transpose1d(xc, wt, None, stride=stride, dilation=dilation)
    end = y.shape[-1] - padding + output_padding
    if end > y.shape[-1]:
        y = F.pad(y, (0, end - y.shape[-1]))
    y = y[..., padding:end]
    if b is not None:
        y = y + b[:, None]
    return y.transpose(1, 2)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: tuple[int, int] = (1, 1),
           padding: tuple[int, int] = (0, 0),
           dilation: tuple[int, int] = (1, 1), groups: int = 1) -> torch.Tensor:
    """x ``(B, H, W, C_in)``, w ``(Kh, Kw, C_in // groups, C_out)``, b
    ``(C_out,)``; symmetric padding per axis. Returns ``(B, H_out, W_out,
    C_out)``."""
    # a contiguous weight: the CPU backward refuses a strided one
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(), b,
                 stride=tuple(stride), padding=tuple(padding),
                 dilation=tuple(dilation), groups=groups)
    return y.permute(0, 2, 3, 1)


def avg_pool1d(x: torch.Tensor, kernel_size: int, stride: int, padding: int,
               count_include_pad: bool = True) -> torch.Tensor:
    """``torch.nn.AvgPool1d`` over the time axis of x ``(B, T, C)``."""
    y = F.avg_pool1d(x.transpose(1, 2), kernel_size, stride, padding,
                     count_include_pad=count_include_pad)
    return y.transpose(1, 2)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)
