"""Weight-norm folding, int8 and bfloat16 weight storage for decode (port of
``articulatory_tpu/utils/quantize.py``, ``utils/weight_norm.py`` and the
JAX ``LoadedModel.to_bf16_weights``), for every model of the registry.

int8 works in the JAX package's parameter layout, so that the folded
weights and the int8 values are those of the JAX package bit for bit:

- Conv1d ``(C_out, C_in, K)`` is ``(K, C_in, C_out)`` there;
- ConvTranspose1d ``(C_in, C_out, K)`` is ``(K, C_in, C_out)``, flipped in
  time;
- Dense ``(out, in)`` is ``(in, out)``;
- an embedding table, a GRU's weights (torch's packing, ``(3H, in)``) and
  the attention's ``w_q`` ... ``w_o`` are JAX's leaves as they are;
- the relative-position table ``(H, 2m - 1, d, 1)`` is ``(H, 2m - 1, d)``.

``fold_weight_norm_`` rescales each ``weight_v`` to the effective weight
``g * v / ||v||`` and resets ``weight_g`` to its norm (the forward then
derives the same kernel from an exactly normalised v).
``quantize_int8_`` applies JAX's rule: every float weight that is of ndim
2 or 3 with at least ``min_size`` elements in the JAX layout becomes ``q =
clip(round(w / s), -127, 127)`` (int8) and ``s = max |w| / 127`` over all
but the JAX layout's last axis (float32); biases, norms, small weights and
4-d kernels (Parallel WaveGAN's upsampling Conv2d) stay float. Weight norm
must be folded first. With weight norm the forward reads ``g * (q s) /
||q s||``, as the JAX package's weight-normed layers do with a
dequantized ``v``.

``cast_bf16_`` stores every float parameter as bfloat16, as JAX casts its
param tree; buffers (BatchNorm's running statistics, JAX's mutables) stay
as they are. The layers compute in their input's dtype from the stored
values.

A GRU's stored values (``models/rnn.py::StoredGRU``) are also written,
dequantized or upcast, into its float32 flat weights, which cuDNN reads.
Each layer freezes its dequantized or cast weights once they are stored:
they are derived on first use and cached.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from articulatory_tpu_torch.layers.conv import (
    Conv1d,
    ConvTranspose1d,
    Dense,
    Embed,
    _Stored,
)
from articulatory_tpu_torch.layers.transformer import (
    MultiHeadAttention,
    _RelativePositional,
)
from articulatory_tpu_torch.models.rnn import StoredGRU

_Layout = tuple[Callable, Callable]  # (to the JAX layout, back)


def _contiguous(fn):  # a C-ordered copy (canonical strides)
    return lambda a: fn(a).copy()


_SAME = (_contiguous(lambda a: a), _contiguous(lambda a: a))


def _layouts(module: nn.Module) -> dict[str, _Layout]:
    """The module's own weights that JAX's rule may quantize, each with its
    map to the JAX layout and back (contiguous numpy arrays)."""
    if isinstance(module, ConvTranspose1d):
        layout = (_contiguous(lambda a: np.transpose(a, (2, 0, 1))[::-1]),
                  _contiguous(lambda a: np.transpose(a[::-1], (1, 2, 0))))
    elif isinstance(module, Conv1d):
        swap = _contiguous(lambda a: np.transpose(a, (2, 1, 0)))
        layout = (swap, swap)
    elif isinstance(module, Dense):
        swap = _contiguous(lambda a: np.transpose(a, (1, 0)))
        layout = (swap, swap)
    elif isinstance(module, (Embed, MultiHeadAttention, StoredGRU)):
        layout = _SAME
    elif isinstance(module, _RelativePositional):
        layout = (_contiguous(lambda a: a[..., 0]),
                  _contiguous(lambda a: a[..., None]))
    else:
        return {}
    return {name: layout for name, p in module.named_parameters(recurse=False)
            if "bias" not in name}


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _set(param: torch.Tensor, value: np.ndarray) -> None:
    with torch.no_grad():
        param.copy_(torch.from_numpy(value))


def fold_weight_norm_(model: nn.Module) -> None:
    """Fold every weight-normed conv of ``model`` in place (the JAX
    package's ``fold_weight_norm``)."""
    for module in model.modules():
        layouts = _layouts(module)
        if not layouts or not getattr(module, "use_weight_norm", False):
            continue
        to_jax, back = layouts["weight_v"]
        v, g = to_jax(_numpy(module.weight_v)), to_jax(_numpy(module.weight_g))
        axes = tuple(i for i, s in enumerate(g.shape) if s == 1)
        w_eff = g * v / np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
        new_g = np.sqrt(np.sum(w_eff * w_eff, axis=axes, keepdims=True))
        _set(module.weight_v, back(w_eff.astype(v.dtype)))
        _set(module.weight_g, back(new_g.astype(g.dtype)))
        module.refresh()


def quantize_array(leaf: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(q int8, s float32) of a kernel in the JAX layout, per last axis."""
    axes = tuple(range(leaf.ndim - 1))  # all but the out-channel
    s = np.max(np.abs(leaf), axis=axes, keepdims=True) / 127.0
    s = np.maximum(s, 1e-12).astype(np.float32)
    q = np.clip(np.round(leaf / s), -127, 127).astype(np.int8)
    return q, s


def quantize_int8_(model: nn.Module, min_size: int = 1024) -> list[str]:
    """Store ``model``'s large float weights as int8 in place; returns the
    names of the weights stored so."""
    done = []
    for prefix, module in model.named_modules():
        for name, (to_jax, back) in _layouts(module).items():
            param = getattr(module, name)
            leaf = to_jax(_numpy(param))
            if (not param.is_floating_point() or leaf.ndim not in (2, 3)
                    or leaf.size < min_size):
                continue
            q, s = quantize_array(leaf)
            module.store(name, int8=torch.from_numpy(back(q)).to(param.device),
                         scale=torch.from_numpy(back(s)).to(param.device))
            done.append(f"{prefix}.{name}")
        _freeze(module)
    return done


def cast_bf16_(model: nn.Module) -> None:
    """Store every float parameter of ``model`` as bfloat16 in place."""
    for module in model.modules():
        for name, param in list(module.named_parameters(recurse=False)):
            if not param.is_floating_point():
                continue
            if isinstance(module, StoredGRU):
                module.store(name, bf16=param.detach().to(torch.bfloat16))
            else:
                param.data = param.data.to(torch.bfloat16)
        _freeze(module)


def _freeze(module: nn.Module) -> None:
    if isinstance(module, _Stored):
        module.freeze()
