"""Fused HiFi-GAN residual pair: ``y = x + conv2(lrelu(conv1(lrelu(x), d)))``.

Replaces ``articulatory_tpu/ops/pallas/resblock.py::resblock_pair_pallas``
(the TPU kernel) with ``csrc/resblock_pair.cu``, a CUDA C++ kernel for Hopper
(``sm_90a``) bound through ctypes. On the generator's main path every shape is
bound by arithmetic (2*C*K flops per activation element moved, 96 to 5632),
not by device memory; the kernel keeps the intermediate ``h`` in shared memory
and runs the two convolutions as fp32 FMAs with f32 accumulation (see the
source for the design). bf16 tensor cores are a later redesign.

``resblock_pair`` dispatches on the tensor's device: a CPU tensor goes to
``resblock_pair_plain``, the same function in plain PyTorch; a CUDA tensor
launches the kernel or raises. ``resblock_pair.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from articulatory_tpu_torch.ops import _build
from articulatory_tpu_torch.ops.conv import conv1d


def resblock_pair_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor | None,
                        w2: torch.Tensor, b2: torch.Tensor | None, *,
                        dilation: int, negative_slope: float = 0.1) -> torch.Tensor:
    """The pair in plain PyTorch. x ``(B, T, C)``; w ``(K, C, C)`` (in, out);
    b ``(C,)`` or None. SAME zero padding for both convs."""
    k1, k2 = w1.shape[0], w2.shape[0]
    h = conv1d(F.leaky_relu(x, negative_slope), w1, b1,
               padding=(k1 - 1) // 2 * dilation, dilation=dilation)
    y = conv1d(F.leaky_relu(h, negative_slope), w2, b2, padding=(k2 - 1) // 2)
    return x + y


@functools.cache
def _kernels() -> dict[torch.dtype, ctypes._CFuncPtr]:
    lib = _build.library("resblock_pair")
    out = {}
    for dtype, name in ((torch.float32, "resblock_pair_f32"),
                        (torch.bfloat16, "resblock_pair_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[dtype] = fn
    lib.resblock_pair_error_string.argtypes = [ctypes.c_int]
    lib.resblock_pair_error_string.restype = ctypes.c_char_p
    return out


def _check(x, w1, b1, w2, b2, dilation) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"resblock_pair takes float32 or bfloat16, got {x.dtype}")
    c = x.shape[2]
    for name, w in (("w1", w1), ("w2", w2)):
        if w.dim() != 3 or w.shape[1:] != (c, c) or w.shape[0] % 2 == 0:
            raise ValueError(f"{name} must be (K, {c}, {c}) with K odd, got "
                             f"{tuple(w.shape)}")
    for name, b in (("b1", b1), ("b2", b2)):
        if b is not None and tuple(b.shape) != (c,):
            raise ValueError(f"{name} must be ({c},), got {tuple(b.shape)}")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t is None:
            continue
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; x is "
                             f"{x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def resblock_pair(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor | None,
                  w2: torch.Tensor, b2: torch.Tensor | None, *, dilation: int,
                  negative_slope: float = 0.1) -> torch.Tensor:
    """Fused residual pair. x ``(B, T, C)`` contiguous, float32 or bfloat16;
    w1 ``(K1, C, C)``, w2 ``(K2, C, C)`` folded, (in, out) order, K odd;
    b ``(C,)`` or None; all of x's dtype and device."""
    if x.device.type == "cpu":
        return resblock_pair_plain(x, w1, b1, w2, b2, dilation=dilation,
                                   negative_slope=negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"resblock_pair runs on cpu or cuda, not {x.device}")
    _check(x, w1, b1, w2, b2, dilation)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = _kernels()[x.dtype]
    bsz, t, c = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), w1.data_ptr(),
                None if b1 is None else b1.data_ptr(), w2.data_ptr(),
                None if b2 is None else b2.data_ptr(), y.data_ptr(),
                bsz, t, c, w1.shape[0], w2.shape[0], dilation,
                negative_slope, stream)
    if rc != 0:
        msg = _build.library("resblock_pair").resblock_pair_error_string(rc)
        raise RuntimeError(f"resblock_pair kernel did not launch for x "
                           f"{tuple(x.shape)} {x.dtype}, K ({w1.shape[0]}, "
                           f"{w2.shape[0]}), dilation {dilation}: CUDA error "
                           f"{rc} ({msg.decode()})")
    resblock_pair.launches += 1
    return y


resblock_pair.launches = 0
