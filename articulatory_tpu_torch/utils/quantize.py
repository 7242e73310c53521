"""Weight-norm folding and int8 weight storage for decode (port of
``articulatory_tpu/utils/quantize.py`` and ``utils/weight_norm.py``).

Both work in the JAX package's kernel layout, so that the folded weights
and the int8 values are those of the JAX package bit for bit:

- Conv1d ``(C_out, C_in, K)`` is ``(K, C_in, C_out)`` there;
- ConvTranspose1d ``(C_in, C_out, K)`` is ``(K, C_in, C_out)``, flipped in
  time;
- Dense ``(out, in)`` is ``(in, out)``.

``fold_weight_norm_`` rescales each ``weight_v`` to the effective weight
``g * v / ||v||`` and resets ``weight_g`` to its norm (the forward then
derives the same kernel from an exactly normalised v).
``quantize_int8_`` stores every float weight of ndim 2 or 3 with at least
``min_size`` elements as ``q = clip(round(w / s), -127, 127)`` (int8) and
``s = max |w| / 127`` per output channel (the last axis of the JAX kernel:
dim 0 of a Conv1d or Dense weight, dim 1 of a ConvTranspose1d weight);
biases and small weights stay float. Weight norm must be folded first.
With weight norm the forward reads ``g * (q s) / ||q s||``, as the JAX
package's weight-normed layers do with a dequantized ``v``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from articulatory_tpu_torch.layers.conv import Conv1d, ConvTranspose1d, Dense


def _layouts(module: nn.Module) -> tuple[Callable, Callable] | None:
    """(to the JAX layout, back) for the module's weights, as contiguous
    numpy arrays; None for modules without such weights."""
    def contiguous(fn):  # a C-ordered copy (canonical strides)
        return lambda a: fn(a).copy()

    if isinstance(module, ConvTranspose1d):
        return (contiguous(lambda a: np.transpose(a, (2, 0, 1))[::-1]),
                contiguous(lambda a: np.transpose(a[::-1], (1, 2, 0))))
    if isinstance(module, Conv1d):
        swap = contiguous(lambda a: np.transpose(a, (2, 1, 0)))
        return swap, swap
    if isinstance(module, Dense):
        swap = contiguous(lambda a: np.transpose(a, (1, 0)))
        return swap, swap
    return None


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _set(param: torch.Tensor, value: np.ndarray) -> None:
    with torch.no_grad():
        param.copy_(torch.from_numpy(value))


def _weight_names(module: nn.Module) -> list[str]:
    if getattr(module, "use_weight_norm", False):
        return ["weight_v", "weight_g"]
    return ["weight"]


def _clear_cache(module: nn.Module) -> None:
    if getattr(module, "_cache", None):
        module._cache = {}


def fold_weight_norm_(model: nn.Module) -> None:
    """Fold every weight-normed conv of ``model`` in place (the JAX
    package's ``fold_weight_norm``)."""
    for module in model.modules():
        layouts = _layouts(module)
        if layouts is None or not getattr(module, "use_weight_norm", False):
            continue
        to_jax, back = layouts
        v, g = to_jax(_numpy(module.weight_v)), to_jax(_numpy(module.weight_g))
        axes = tuple(i for i, s in enumerate(g.shape) if s == 1)
        w_eff = g * v / np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
        new_g = np.sqrt(np.sum(w_eff * w_eff, axis=axes, keepdims=True))
        _set(module.weight_v, back(w_eff.astype(v.dtype)))
        _set(module.weight_g, back(new_g.astype(g.dtype)))
        _clear_cache(module)


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
        layouts = _layouts(module)
        if layouts is None:
            continue
        to_jax, back = layouts
        for name in _weight_names(module):
            param = getattr(module, name)
            if (not param.is_floating_point() or param.dim() not in (2, 3)
                    or param.numel() < min_size):
                continue
            q, s = quantize_array(to_jax(_numpy(param)))
            module.store_int8(name, torch.from_numpy(back(q)).to(param.device),
                              torch.from_numpy(back(s)).to(param.device))
            done.append(f"{prefix}.{name}")
        _clear_cache(module)
    return done
