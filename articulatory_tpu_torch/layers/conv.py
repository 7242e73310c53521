"""Conv1d, ConvTranspose1d and Dense with the reference's torch parameters.

Parameters carry torch's names and layouts, so ``state_dict()`` has the keys
``articulatory_tpu/utils/torch_export.py`` produces and reference torch
pickles load straight in:

- Conv1d: ``weight`` or ``weight_g`` (C_out, 1, 1) / ``weight_v``
  (C_out, C_in // groups, K), and ``bias`` (C_out,);
- ConvTranspose1d: ``weight`` or ``weight_g`` (C_in, 1, 1) / ``weight_v``
  (C_in, C_out, K), and ``bias``; torch's weight-norm dim 0 is the *input*
  channel here;
- Dense: ``weight`` (out, in), ``bias`` (out,).

Weight norm is ``w = g * v / ||v||`` over every axis but 0. The forward
derives the effective kernel in the ops layout (``ops/conv.py``) from (g, v);
after ``remove_weight_norm()`` it is computed once per dtype and cached.
Inits follow torch's defaults (U(+-1/sqrt(fan_in)) for kernel and bias), or
N(0, std) for ``kernel_init="normal:<std>"``; random numbers come from the
``generator`` passed in.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from articulatory_tpu_torch.ops import conv as conv_ops


def _default_generator(generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def _uniform(shape, bound: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound,
                                                    generator=generator))


def _kernel_init(shape, fan_in: int, kernel_init: str,
                 generator: torch.Generator) -> torch.Tensor:
    if kernel_init == "torch_default":
        return torch.empty(shape).uniform_(-1.0 / math.sqrt(fan_in),
                                           1.0 / math.sqrt(fan_in),
                                           generator=generator)
    if kernel_init.startswith("normal:"):
        std = float(kernel_init.split(":", 1)[1])
        return torch.empty(shape).normal_(0.0, std, generator=generator)
    raise ValueError(f"Unknown kernel init: {kernel_init}")


def weight_norm_weight(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``g * v / ||v||``, the norm over every axis but 0 (torch dim=0)."""
    norm = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return g * v / norm


class _Conv(nn.Module):
    """Parameters and kernel cache shared by Conv1d and ConvTranspose1d."""

    def _make_params(self, shape, fan_in: int, out_channels: int, bias: bool,
                     use_weight_norm: bool, kernel_init: str,
                     generator: torch.Generator | None) -> None:
        generator = _default_generator(generator)
        self.use_weight_norm = use_weight_norm
        w = _kernel_init(shape, fan_in, kernel_init, generator)
        if use_weight_norm:
            self.weight_v = nn.Parameter(w)
            self.weight_g = nn.Parameter(
                w.square().sum(dim=(1, 2), keepdim=True).sqrt())
        else:
            self.weight = nn.Parameter(w)
        self.bias = (_uniform((out_channels,), 1.0 / math.sqrt(fan_in), generator)
                     if bias else None)
        self._cache: dict | None = None  # dtype -> (kernel, bias) once folded

    def torch_weight(self) -> torch.Tensor:
        """The effective weight in torch's layout."""
        if self.use_weight_norm:
            return weight_norm_weight(self.weight_g, self.weight_v)
        return self.weight

    def _ops_kernel(self, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def kernel(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(kernel in the ops layout, bias), contiguous, in ``dtype``."""
        if self._cache is not None and dtype in self._cache:
            return self._cache[dtype]
        w = self._ops_kernel(self.torch_weight()).to(dtype).contiguous()
        b = None if self.bias is None else self.bias.to(dtype)
        if self._cache is not None:
            self._cache[dtype] = (w.detach(), None if b is None else b.detach())
        return w, b

    def remove_weight_norm(self) -> None:
        """Freeze the weights: the kernel is derived once per dtype and
        cached. Outputs are unchanged."""
        self._cache = {}

    def _apply(self, fn, *args, **kwargs):
        if self._cache:
            self._cache = {}
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        if self._cache:
            self._cache = {}
        super()._load_from_state_dict(*args, **kwargs)


class Conv1d(_Conv):
    """PyTorch-semantics Conv1d over NLC input, optional weight norm.

    ``forward(x, dtype)``: with ``dtype`` the input, kernel and bias are cast
    to it; without, the layer computes in the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int | tuple[int, int] = 0,
                 dilation: int = 1, groups: int = 1, bias: bool = True,
                 use_weight_norm: bool = False, kernel_init: str = "torch_default",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        shape = (out_channels, in_channels // groups, kernel_size)
        self._make_params(shape, shape[1] * kernel_size, out_channels, bias,
                          use_weight_norm, kernel_init, generator)

    def _ops_kernel(self, w: torch.Tensor) -> torch.Tensor:
        return w.permute(2, 1, 0)  # (C_out, C_in, K) -> (K, C_in, C_out)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None
                ) -> torch.Tensor:
        dtype = dtype or x.dtype
        w, b = self.kernel(dtype)
        return conv_ops.conv1d(x.to(dtype), w, b, stride=self.stride,
                               padding=self.padding, dilation=self.dilation,
                               groups=self.groups)


class ConvTranspose1d(_Conv):
    """PyTorch-semantics ConvTranspose1d over NLC input, optional weight norm
    (per input channel, torch's dim 0 of its (C_in, C_out, K) weight)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, output_padding: int = 0,
                 dilation: int = 1, bias: bool = True,
                 use_weight_norm: bool = False, kernel_init: str = "torch_default",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.output_padding, self.dilation = output_padding, dilation
        shape = (in_channels, out_channels, kernel_size)
        # torch's fan_in for a (C_in, C_out, K) transposed weight is C_out * K
        self._make_params(shape, out_channels * kernel_size, out_channels,
                          bias, use_weight_norm, kernel_init, generator)

    def _ops_kernel(self, w: torch.Tensor) -> torch.Tensor:
        return w.permute(2, 0, 1).flip(0)  # -> pre-flipped (K, C_in, C_out)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None
                ) -> torch.Tensor:
        dtype = dtype or x.dtype
        w, b = self.kernel(dtype)
        return conv_ops.conv_transpose1d(
            x.to(dtype), w, b, stride=self.stride, padding=self.padding,
            output_padding=self.output_padding, dilation=self.dilation)


class Dense(nn.Module):
    """torch.nn.Linear with torch's default init from an explicit generator."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        generator = _default_generator(generator)
        bound = 1.0 / math.sqrt(in_features)
        self.weight = _uniform((out_features, in_features), bound, generator)
        self.bias = _uniform((out_features,), bound, generator) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.linear(x, self.weight, self.bias)
