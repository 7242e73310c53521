"""StyleMelGAN TADE layers (port of ``articulatory_tpu/layers/tade.py``),
over NLC ``(B, T, C)``.

``TADELayer``: instance-normalise x over time, upsample the aux features,
``c = aux_conv(c)``, ``(g1, g2) = gated_conv(c)``, ``y = g1 * up(x) + g2``;
returns ``(y, c)``. Keys ``aux_conv.0``, ``gated_conv.0`` (weight norm).

``TADEResBlock``: two TADE layers, each followed by a gated conv and
``gate(a) * tanh(b)`` (``softmax`` over channels or ``sigmoid``), plus the
upsampled residual. Keys ``tade1``, ``gated_conv1``, ``tade2``,
``gated_conv2``. ``upsample_mode`` is ``nearest`` (repetition) or
``linear`` (``ops/interp.py``); as in the JAX package, a ``TADEResBlock``
applies it to its residual only, its two TADE layers upsampling by
repetition.
"""

from __future__ import annotations

import torch
from torch import nn

from articulatory_tpu_torch.layers.conv import Conv1d
from articulatory_tpu_torch.layers.residual import nearest_upsample
from articulatory_tpu_torch.ops.interp import interpolate_linear


def instance_norm_time(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``torch.nn.InstanceNorm1d`` (no affine): each (b, c) over time."""
    var, mean = torch.var_mean(x, dim=1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


def _check_mode(mode: str) -> None:
    if mode not in ("nearest", "linear"):
        raise ValueError(f"unsupported upsample_mode {mode!r} (supported: "
                         f"nearest, linear)")


def _upsample(x: torch.Tensor, factor: int, mode: str) -> torch.Tensor:
    if mode == "nearest":
        return nearest_upsample(x, factor)
    return interpolate_linear(x, x.shape[1] * factor)


class TADELayer(nn.Module):
    def __init__(self, in_channels: int = 64, aux_channels: int = 80,
                 kernel_size: int = 9, bias: bool = True,
                 upsample_factor: int = 2, upsample_mode: str = "nearest",
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_mode(upsample_mode)
        self.upsample_factor, self.upsample_mode = upsample_factor, upsample_mode
        conv = dict(padding=(kernel_size - 1) // 2, bias=bias,
                    use_weight_norm=True, generator=generator)
        self.aux_conv = nn.ModuleList([Conv1d(aux_channels, in_channels,
                                              kernel_size, **conv)])
        self.gated_conv = nn.ModuleList([Conv1d(in_channels, in_channels * 2,
                                                kernel_size, **conv)])

    def forward(self, x: torch.Tensor, c: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        x = instance_norm_time(x)
        f, mode = self.upsample_factor, self.upsample_mode
        c = self.aux_conv[0](_upsample(c, f, mode))
        g1, g2 = self.gated_conv[0](c).chunk(2, dim=-1)
        return g1 * _upsample(x, f, mode) + g2, c


class TADEResBlock(nn.Module):
    def __init__(self, in_channels: int = 64, aux_channels: int = 80,
                 kernel_size: int = 9, dilation: int = 2, bias: bool = True,
                 upsample_factor: int = 2, upsample_mode: str = "nearest",
                 gated_function: str = "softmax",
                 generator: torch.Generator | None = None):
        super().__init__()
        if gated_function not in ("softmax", "sigmoid"):
            raise ValueError(f"{gated_function} is not supported.")
        _check_mode(upsample_mode)
        self.gated_function = gated_function
        self.upsample_factor, self.upsample_mode = upsample_factor, upsample_mode
        # the JAX package builds both TADE layers with their default
        # (nearest) mode; only the residual reads upsample_mode
        self.tade1 = TADELayer(in_channels, aux_channels, kernel_size, bias,
                               1, "nearest", generator)
        self.gated_conv1 = Conv1d(in_channels, in_channels * 2, kernel_size,
                                  padding=(kernel_size - 1) // 2, bias=bias,
                                  use_weight_norm=True, generator=generator)
        self.tade2 = TADELayer(in_channels, in_channels, kernel_size, bias,
                               upsample_factor, "nearest", generator)
        self.gated_conv2 = Conv1d(in_channels, in_channels * 2, kernel_size,
                                  dilation=dilation,
                                  padding=(kernel_size - 1) // 2 * dilation,
                                  bias=bias, use_weight_norm=True,
                                  generator=generator)

    def _gate(self, z: torch.Tensor) -> torch.Tensor:
        a, b = z.chunk(2, dim=-1)
        g = (torch.softmax(a, dim=-1) if self.gated_function == "softmax"
             else torch.sigmoid(a))
        return g * torch.tanh(b)

    def forward(self, x: torch.Tensor, c: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        residual = x
        x, c = self.tade1(x, c)
        x = self._gate(self.gated_conv1(x))
        x, c = self.tade2(x, c)
        x = self._gate(self.gated_conv2(x))
        return _upsample(residual, self.upsample_factor,
                         self.upsample_mode) + x, c
