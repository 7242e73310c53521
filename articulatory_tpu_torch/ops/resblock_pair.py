"""Fused HiFi-GAN residual pair: ``y = x + conv2(lrelu(conv1(lrelu(x), d)))``.

Replaces ``articulatory_tpu/ops/pallas/resblock.py::resblock_pair_pallas``
(the TPU kernel) with ``csrc/resblock_pair.cu``, CUDA C++ kernels for Hopper
(``sm_90a``) bound through ctypes. Both keep the intermediate ``h`` in shared
memory. float32 (the parity mode) runs the two convolutions as fp32 FMAs;
bfloat16 runs them on the tensor cores (wgmma, weight tiles fed by TMA), with
f32 accumulation (see the source for the design). The bf16 kernel takes C a
multiple of 16 up to 256: ``_launch`` zero-pads other C (``pad_channels``,
exact) and slices the result; a wider bf16 C raises.

``resblock_pair`` dispatches on the tensor's device: a CPU tensor goes to
``resblock_pair_plain``, the same function in plain PyTorch; a CUDA tensor
launches the kernel or raises. ``resblock_pair.launches`` counts launches.

Gradients: the JAX package has no backward for this kernel (its models
differentiate through XLA convs). On a CUDA tensor that needs a gradient the
pair runs inside ``ResblockPairFunction``: forward launches the kernel
through ``_launch`` and saves x, w1, b1, w2, b2; backward recomputes
``resblock_pair_plain`` under autograd and differentiates it
(``ops/_recompute.py``), one extra plain forward and no intermediate
activation kept. Without grad mode, or when no input requires a gradient (the
decode), ``_forward`` calls ``_launch`` directly, saving the Function's host
time. ``_launch`` is a module function, so a test can stand the plain version
in for the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from articulatory_tpu_torch.ops import _build
from articulatory_tpu_torch.ops._recompute import recompute_grads
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


# widest C the bf16 kernel takes, and the multiple it takes C in
BF16_MAX_CHANNELS = 256
BF16_CHANNEL_MULTIPLE = 16


def pad_channels(x, w1, b1, w2, b2, multiple: int):
    """Zero-pad the channel axis of the pair's inputs to a multiple of
    ``multiple``. Exact: a padded channel is zero in x, h and y, and adds
    zero to every real channel."""
    pad = -x.shape[2] % multiple
    if pad == 0:
        return x, w1, b1, w2, b2
    return (F.pad(x, (0, pad)), F.pad(w1, (0, pad, 0, pad)),
            None if b1 is None else F.pad(b1, (0, pad)),
            F.pad(w2, (0, pad, 0, pad)),
            None if b2 is None else F.pad(b2, (0, pad)))


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
    if x.dtype == torch.bfloat16 and c > BF16_MAX_CHANNELS:
        raise ValueError(f"the bf16 kernel takes at most {BF16_MAX_CHANNELS} "
                         f"channels, got {c}")
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t is None:
            continue
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; x is "
                             f"{x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(x, w1, b1, w2, b2, dilation, negative_slope):
    """Launch the kernel on CUDA tensors that passed ``_check``."""
    c = x.shape[2]
    if x.dtype == torch.bfloat16 and c % BF16_CHANNEL_MULTIPLE:
        padded = pad_channels(x, w1, b1, w2, b2, BF16_CHANNEL_MULTIPLE)
        return _launch(*padded, dilation,
                       negative_slope)[..., :c].contiguous()
    if x.device.index != torch.cuda.current_device():
        # the kernel launches on the current device
        with torch.cuda.device(x.device):
            return _launch(x, w1, b1, w2, b2, dilation, negative_slope)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = _kernels()[x.dtype]
    bsz, t, c = x.shape
    # the raw handle: torch.cuda.current_stream() builds a Stream object on
    # every call
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
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


class ResblockPairFunction(torch.autograd.Function):
    """Forward: ``_launch`` (the kernel). Backward: the plain pair
    recomputed under autograd, differentiated with respect to every input
    that needs a gradient."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, dilation, negative_slope):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.dilation, ctx.negative_slope = dilation, negative_slope
        return _launch(x, w1, b1, w2, b2, dilation, negative_slope)

    @staticmethod
    def backward(ctx, gy):
        return (*recompute_grads(resblock_pair_plain, ctx.saved_tensors,
                                 ctx.needs_input_grad[:5], gy,
                                 dilation=ctx.dilation,
                                 negative_slope=ctx.negative_slope),
                None, None)


def resblock_pair(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor | None,
                  w2: torch.Tensor, b2: torch.Tensor | None, *, dilation: int,
                  negative_slope: float = 0.1) -> torch.Tensor:
    """Fused residual pair. x ``(B, T, C)`` contiguous, float32 or bfloat16;
    w1 ``(K1, C, C)``, w2 ``(K2, C, C)`` folded, (in, out) order, K odd;
    b ``(C,)`` or None; all of x's dtype and device. Differentiable in
    every tensor input."""
    if x.device.type == "cpu":
        return resblock_pair_plain(x, w1, b1, w2, b2, dilation=dilation,
                                   negative_slope=negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"resblock_pair runs on cpu or cuda, not {x.device}")
    _check(x, w1, b1, w2, b2, dilation)
    return _forward(x, w1, b1, w2, b2, dilation, negative_slope)


def _forward(x, w1, b1, w2, b2, dilation, negative_slope):
    """The Function where a gradient is wanted, else the bare launch."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w1, b1, w2, b2)):
        return ResblockPairFunction.apply(x, w1, b1, w2, b2, dilation,
                                          negative_slope)
    return _launch(x, w1, b1, w2, b2, dilation, negative_slope)


resblock_pair.launches = 0
