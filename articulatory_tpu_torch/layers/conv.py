"""Conv1d, ConvTranspose1d, Conv2d and Dense with the reference's torch
parameters.

Parameters carry torch's names and layouts, so ``state_dict()`` has the keys
``articulatory_tpu/utils/torch_export.py`` produces and reference torch
pickles load straight in:

- Conv1d: ``weight`` or ``weight_g`` (C_out, 1, 1) / ``weight_v``
  (C_out, C_in // groups, K), and ``bias`` (C_out,);
- ConvTranspose1d: ``weight`` or ``weight_g`` (C_in, 1, 1) / ``weight_v``
  (C_in, C_out, K), and ``bias``; torch's weight-norm dim 0 is the *input*
  channel here;
- Conv2d (NHWC input): ``weight`` or ``weight_g`` (C_out, 1, 1, 1) /
  ``weight_v`` (C_out, C_in // groups, Kh, Kw), and ``bias``;
- Dense: ``weight`` (out, in), ``bias`` (out,).

Weight norm is ``w = g * v / ||v||`` over every axis but 0. The forward
derives the effective kernel in the ops layout (``ops/conv.py``) from (g, v);
after ``remove_weight_norm()`` it is computed once per dtype and cached.
Conv2d's spectral norm divides the kernel by its largest singular value,
estimated afresh at every forward (``spectral_normalize``).
A weight may be stored as int8 (``store``: buffers ``<name>_int8`` and
``<name>_scale``, the parameter removed; ``utils/quantize.py``), read back
as ``q.float() * s``, or in bfloat16: the effective weight is then derived
in bfloat16, as the JAX package's layers define it, and cast to the compute
dtype (its jitted forward lets XLA skip some of those bf16 roundings, so
the two differ at bf16 rounding). Stored weights are frozen: a layer
derives each in a dtype once and caches it (``_Stored.weight_as``).
Inits follow torch's defaults (U(+-1/sqrt(fan_in)) for kernel and bias), or
N(0, std) for ``kernel_init="normal:<std>"``, N(0, sqrt(2 / fan_in)) for
``"kaiming_normal_relu"`` and zero biases for ``bias_init="zeros"``; random
numbers come from the ``generator`` passed in. ``Embed`` is
``torch.nn.Embedding`` (N(0, 1) init, key ``weight``).

``CausalConv1d`` and ``CausalConvTranspose1d`` are the reference's
``causal_conv.py`` layers (the JAX package's ``layers/conv.py:297-336``):
the first left-pads the input by ``(K - 1) * dilation`` with ``pad_value``
before its inner ``conv``, the second drops the last ``stride`` samples of
its inner ``deconv``; keys ``conv.*`` and ``deconv.*``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
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
    if kernel_init == "kaiming_normal_relu":
        return torch.empty(shape).normal_(0.0, math.sqrt(2.0 / fan_in),
                                          generator=generator)
    raise ValueError(f"Unknown kernel init: {kernel_init}")


def weight_norm_weight(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``g * v / ||v||``, the norm over every axis but 0 (torch dim=0)."""
    norm = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return g * v / norm


def spectral_normalize(w: torch.Tensor, out_axis: int = -1,
                       n_iter: int = 5) -> torch.Tensor:
    """``w / sigma_max(W)``, W the matrix of ``w`` with ``out_axis`` as
    rows, by ``n_iter`` power iterations from ``ones / sqrt(c_out)``; no
    gradient flows through the iteration, only through ``w`` (the JAX
    package's stateless ``spectral_normalize``, not torch's persistent-``u``
    ``spectral_norm``)."""
    c_out = w.shape[out_axis]
    mat = torch.movedim(w, out_axis, 0).reshape(c_out, -1)
    m = mat.detach()
    u = torch.ones(c_out, dtype=w.dtype, device=w.device) / math.sqrt(c_out)
    for _ in range(n_iter):
        v = m.T @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u = m @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
    return w / (u @ (mat @ v))


class _Stored(nn.Module):
    """Weights that may be stored as int8 (per-channel scale) or bfloat16,
    and the cache of frozen weights: once ``freeze()`` is called, each
    weight derived in a dtype (``weight_as``, a conv's ``kernel``) is
    derived once and kept until the module is moved or loaded."""

    _frozen: dict | None = None  # (name, dtype) -> weight, once frozen

    def stored(self, name: str) -> torch.Tensor:
        """Parameter ``name``, dequantized (``q.float() * s``) if it is
        stored as int8."""
        q = self._buffers.get(f"{name}_int8")
        if q is None:
            return getattr(self, name)
        return q.float() * self._buffers[f"{name}_scale"]

    def store(self, name: str, **buffers: torch.Tensor) -> None:
        """Replace parameter ``name`` by buffers ``<name>_<key>``: int8
        values ``int8`` and float32 scales ``scale`` (broadcast against
        them)."""
        delattr(self, name)
        for key, value in buffers.items():
            self.register_buffer(f"{name}_{key}", value)

    def freeze(self) -> None:
        """Cache each weight derived from now on (dropping any cached)."""
        self._frozen = {}

    def refresh(self) -> None:
        """Drop the cached weights (after the parameters changed); a frozen
        module stays frozen."""
        if self._frozen:
            self._frozen = {}

    def _derived(self, key: tuple, make) -> torch.Tensor | None:
        """``make()``, cached under ``key`` once frozen: every call returns
        the same tensor, so what a kernel keeps with it (resblock_pair's f32
        weight split) is made once."""
        if self._frozen is None:
            return make()
        if key not in self._frozen:
            w = make()
            self._frozen[key] = None if w is None else w.detach()
        return self._frozen[key]

    def weight_as(self, name: str, dtype: torch.dtype | None
                  ) -> torch.Tensor | None:
        """``stored(name)`` cast to ``dtype`` (as stored with None)."""
        def make():
            w = self.stored(name)
            return w if w is None or dtype is None else w.to(dtype)
        return self._derived((name, dtype), make)

    def _apply(self, fn, *args, **kwargs):
        self.refresh()
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self.refresh()
        super()._load_from_state_dict(*args, **kwargs)


class _Conv(_Stored):
    """Parameters and frozen kernel shared by the convs."""

    def _make_params(self, shape, fan_in: int, out_channels: int, bias: bool,
                     use_weight_norm: bool, kernel_init: str,
                     generator: torch.Generator | None,
                     bias_init: str = "torch_default") -> None:
        generator = _default_generator(generator)
        self.use_weight_norm = use_weight_norm
        w = _kernel_init(shape, fan_in, kernel_init, generator)
        if use_weight_norm:
            self.weight_v = nn.Parameter(w)
            self.weight_g = nn.Parameter(w.square().sum(
                dim=tuple(range(1, w.dim())), keepdim=True).sqrt())
        else:
            self.weight = nn.Parameter(w)
        if not bias:
            self.bias = None
        elif bias_init == "zeros":
            self.bias = nn.Parameter(torch.zeros(out_channels))
        else:
            self.bias = _uniform((out_channels,), 1.0 / math.sqrt(fan_in),
                                 generator)

    def torch_weight(self) -> torch.Tensor:
        """The effective weight in torch's layout."""
        if self.use_weight_norm:
            return weight_norm_weight(self.stored("weight_g"),
                                      self.stored("weight_v"))
        return self.stored("weight")

    def _ops_kernel(self, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def kernel(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(kernel in the ops layout, bias), contiguous, in ``dtype``."""
        w = self._derived(("kernel", dtype), lambda: self._ops_kernel(
            self.torch_weight()).to(dtype).contiguous())
        return w, self.weight_as("bias", dtype)

    def remove_weight_norm(self) -> None:
        """Freeze the weights: the kernel is derived once per dtype and
        cached. Outputs are unchanged."""
        self.freeze()


class Conv1d(_Conv):
    """PyTorch-semantics Conv1d over NLC input, optional weight norm.

    ``pad_mode`` ``reflect`` or ``replicate`` pads the input that way (the
    reference's pad layer before the conv) instead of with zeros.
    ``forward(x, dtype)``: with ``dtype`` the input, kernel and bias are cast
    to it; without, the layer computes in the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int | tuple[int, int] = 0,
                 dilation: int = 1, groups: int = 1, bias: bool = True,
                 use_weight_norm: bool = False, kernel_init: str = "torch_default",
                 generator: torch.Generator | None = None,
                 pad_mode: str = "zeros", bias_init: str = "torch_default"):
        super().__init__()
        if pad_mode not in ("zeros", "reflect", "replicate"):
            raise ValueError(f"unsupported pad_mode {pad_mode!r}")
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.pad_mode = pad_mode
        shape = (out_channels, in_channels // groups, kernel_size)
        self._make_params(shape, shape[1] * kernel_size, out_channels, bias,
                          use_weight_norm, kernel_init, generator, bias_init)

    def _ops_kernel(self, w: torch.Tensor) -> torch.Tensor:
        return w.permute(2, 1, 0)  # (C_out, C_in, K) -> (K, C_in, C_out)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None
                ) -> torch.Tensor:
        dtype = dtype or x.dtype
        w, b = self.kernel(dtype)
        padding = self.padding
        if self.pad_mode != "zeros" and padding != 0:
            lo, hi = (padding, padding) if isinstance(padding, int) else padding
            x = F.pad(x.transpose(1, 2), (lo, hi), mode=self.pad_mode
                      ).transpose(1, 2)
            padding = 0
        return conv_ops.conv1d(x.to(dtype), w, b, stride=self.stride,
                               padding=padding, dilation=self.dilation,
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


class Conv2d(_Conv):
    """PyTorch-semantics Conv2d over NHWC input, optional weight norm (per
    output channel) or spectral norm (``spectral_normalize`` of the kernel
    in the ops layout, out channels last, at every forward; its key stays
    ``weight``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: tuple[int, int], stride: tuple[int, int] = (1, 1),
                 padding: tuple[int, int] = (0, 0),
                 dilation: tuple[int, int] = (1, 1), groups: int = 1,
                 bias: bool = True, use_weight_norm: bool = False,
                 use_spectral_norm: bool = False,
                 kernel_init: str = "torch_default",
                 generator: torch.Generator | None = None):
        super().__init__()
        if use_weight_norm and use_spectral_norm:
            raise ValueError("Either use use_weight_norm or use_spectral_norm.")
        self.use_spectral_norm = use_spectral_norm
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.dilation, self.groups = tuple(dilation), groups
        shape = (out_channels, in_channels // groups, *kernel_size)
        self._make_params(shape, shape[1] * kernel_size[0] * kernel_size[1],
                          out_channels, bias, use_weight_norm, kernel_init,
                          generator)

    def _ops_kernel(self, w: torch.Tensor) -> torch.Tensor:
        w = w.permute(2, 3, 1, 0)  # -> (Kh, Kw, C_in, C_out)
        return spectral_normalize(w) if self.use_spectral_norm else w

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None
                ) -> torch.Tensor:
        dtype = dtype or x.dtype
        w, b = self.kernel(dtype)
        return conv_ops.conv2d(x.to(dtype), w, b, stride=self.stride,
                               padding=self.padding, dilation=self.dilation,
                               groups=self.groups)


class Dense(_Stored):
    """torch.nn.Linear with torch's default init from an explicit generator.
    Weights stored in another dtype than the input's (bf16, int8) are cast
    to it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        generator = _default_generator(generator)
        bound = 1.0 / math.sqrt(in_features)
        self.weight = _uniform((out_features, in_features), bound, generator)
        self.bias = _uniform((out_features,), bound, generator) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.linear(x, self.weight_as("weight", x.dtype),
                                          self.weight_as("bias", x.dtype))


class Embed(_Stored):
    """torch.nn.Embedding: ``weight`` (num_embeddings, features), N(0, 1);
    looked up in the dtype it is stored in (int8 dequantized)."""

    def __init__(self, num_embeddings: int, features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features).normal_(
            generator=_default_generator(generator)))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight_as("weight", None)[ids]


class CausalConv1d(nn.Module):
    """Conv1d over NLC input left-padded by ``(K - 1) * dilation`` with
    ``pad_value``: output t sees inputs up to t only."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, bias: bool = True,
                 use_weight_norm: bool = False, pad_value: float = 0.0,
                 kernel_init: str = "torch_default",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation
        self.pad_value = pad_value
        self.conv = Conv1d(in_channels, out_channels, kernel_size,
                           dilation=dilation, bias=bias,
                           use_weight_norm=use_weight_norm,
                           kernel_init=kernel_init, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None
                ) -> torch.Tensor:
        x = F.pad(x, (0, 0, self.pad, 0), value=self.pad_value)
        return self.conv(x, dtype)


class CausalConvTranspose1d(nn.Module):
    """Unpadded ConvTranspose1d (kernel ``2 * stride`` in the zoo) with its
    last ``stride`` samples dropped: T frames become T * stride."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, bias: bool = True,
                 use_weight_norm: bool = False,
                 kernel_init: str = "torch_default",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride = stride
        self.deconv = ConvTranspose1d(in_channels, out_channels, kernel_size,
                                      stride=stride, bias=bias,
                                      use_weight_norm=use_weight_norm,
                                      kernel_init=kernel_init,
                                      generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None
                ) -> torch.Tensor:
        return self.deconv(x, dtype)[:, : -self.stride]


def remove_weight_norm(model: nn.Module) -> None:
    """Freeze every conv of ``model``: each kernel is derived once per dtype
    and cached from then on; outputs are unchanged."""
    for m in model.modules():
        if isinstance(m, _Conv):
            m.remove_weight_norm()
