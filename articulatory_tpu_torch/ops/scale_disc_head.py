"""HiFi-GAN scale-discriminator head: layers 0 and 1 of the MSD stack.

``h0 = lrelu(conv(x, w0, k 15, 1 -> 128, pad 7))``;
``h1 = lrelu(grouped conv(h0, wg, k 41, 128 -> 128, 4 groups, stride s,
pad 20))``, with h0's rows outside [0, T) zero in layer 1.

Replaces ``articulatory_tpu/ops/pallas/scale_disc_head.py::scale_disc_head_pallas``
(:150, the TPU kernel) with ``csrc/scale_disc_head.cu``, a CUDA C++ kernel
for Hopper (``sm_90a``) bound through ctypes (see the source for the
design). Layer 0 runs fp32 FMAs into a polyphase h0 window in shared memory
(each h0 row written to device memory once); layer 1, 96 % of the flops, is
an implicit GEMM per group on the tensor cores (wgmma): bf16 operands in
bfloat16, 3xTF32 in float32 (each operand split into tf32 hi and lo, three
products a multiply-add, close to f32 accuracy). Each output channel sums
over its own group only (the Pallas kernel densified the grouped weight,
four times the work). Unlike the Pallas kernel it takes the stride as an
argument (the repo's configs run layer 1 at stride 4), any T >= 1, and
returns h0 in natural time order, not split even/odd.

wgmma reads 32-bit weights only K-major, so wg goes through a prep kernel
first (``split_weights``: (tap, in, out) into (parts, tap, out, in), tf32 hi
then lo in float32, the weights as they are in bfloat16);
``split_weights_plain`` is the same in PyTorch. It runs in every call: the
head's weights are the discriminator's, which move every training step.

``scale_disc_head`` dispatches on the tensor's device: a CPU tensor goes to
``scale_disc_head_plain``, the same function as two ``ops/conv.py::conv1d``
calls (whose zero padding of h0 is the kernel's mask); a CUDA tensor
launches the kernel or raises. ``scale_disc_head.launches`` counts the
head's launches (``launches_by_dtype`` apart per dtype name),
``split_weights.launches`` the prep kernel's.

Gradients: the JAX package has no backward for this kernel (its models
differentiate through XLA convs). The ``torch.autograd.Function`` here
launches the kernel forward and, in backward, recomputes the plain version
and differentiates that: one extra plain forward, and no intermediate
activation kept between forward and backward.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from articulatory_tpu_torch.ops import _build
from articulatory_tpu_torch.ops._recompute import recompute_grads
from articulatory_tpu_torch.ops.conv import conv1d
from articulatory_tpu_torch.ops.resblock_pair import round_tf32

K0, K1 = 15, 41
PAD0, PAD1 = (K0 - 1) // 2, (K1 - 1) // 2
CHANNELS = 128
GROUPS = 4


def scale_disc_head_output_length(length: int, stride: int) -> int:
    """h1's length: layer 1's ``(T + 2*20 - 41) // stride + 1``."""
    return (length - 1) // stride + 1


def scale_disc_head_plain(x: torch.Tensor, w0: torch.Tensor,
                          b0: torch.Tensor | None, wg: torch.Tensor,
                          b1: torch.Tensor | None, *, stride: int,
                          negative_slope: float = 0.1
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The head in plain PyTorch. x ``(B, T, 1)``; w0 ``(15, 1, 128)``;
    wg ``(41, 32, 128)`` grouped (tap, in within the group, out); b
    ``(128,)`` or None. Returns h0 ``(B, T, 128)``, h1 ``(B, T1, 128)``."""
    h0 = F.leaky_relu(conv1d(x, w0, b0, padding=PAD0), negative_slope)
    h1 = F.leaky_relu(conv1d(h0, wg, b1, stride=stride, padding=PAD1,
                             groups=GROUPS), negative_slope)
    return h0, h1


def split_weights_plain(wg: torch.Tensor) -> torch.Tensor:
    """The prep kernel's function in PyTorch: wg ``(41, 32, 128)`` (tap, in,
    out) into ``(parts, 41, 128, 32)`` (tap, out, in): float32 [0] ``hi =
    tf32(wg)``, [1] ``lo = tf32(wg - hi)``; bfloat16 [0] wg as it is."""
    wt = wg.transpose(1, 2)
    if wg.dtype == torch.bfloat16:
        return wt.unsqueeze(0).contiguous()
    hi = round_tf32(wt)
    return torch.stack((hi, round_tf32(wt - hi)))


@functools.cache
def _kernels() -> dict[tuple[str, torch.dtype], ctypes._CFuncPtr]:
    """The head's and the prep kernel's entries, per dtype."""
    lib = _build.library("scale_disc_head")
    out = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        fn = getattr(lib, f"scale_disc_head_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out["head", dtype] = fn
        split = getattr(lib, f"scale_disc_head_split_{suffix}")
        split.argtypes = [ctypes.c_void_p] * 3
        split.restype = ctypes.c_int
        out["split", dtype] = split
    lib.scale_disc_head_error_string.argtypes = [ctypes.c_int]
    lib.scale_disc_head_error_string.restype = ctypes.c_char_p
    return out


def _launch_error(rc: int, what: str) -> RuntimeError:
    msg = _build.library("scale_disc_head").scale_disc_head_error_string(rc)
    return RuntimeError(f"{what} did not launch: CUDA error {rc} "
                        f"({msg.decode()})")


def split_weights(wg: torch.Tensor) -> torch.Tensor:
    """``split_weights_plain`` of wg ``(41, 32, 128)``, float32 or bfloat16:
    on a CUDA tensor one launch of the prep kernel, on a CPU tensor the
    plain version."""
    if wg.device.type == "cpu":
        return split_weights_plain(wg)
    shape = (K1, CHANNELS // GROUPS, CHANNELS)
    if (wg.dtype not in (torch.float32, torch.bfloat16)
            or tuple(wg.shape) != shape or not wg.is_contiguous()):
        raise ValueError(f"wg must be a contiguous float32 or bfloat16 "
                         f"{shape}, got {wg.dtype} {tuple(wg.shape)}")
    if wg.device.index != torch.cuda.current_device():
        with torch.cuda.device(wg.device):
            return _split(wg)
    return _split(wg)


def _split(wg):
    """The prep kernel's launch on a weight already checked, on the current
    device."""
    parts = 2 if wg.dtype == torch.float32 else 1
    ws = torch.empty((parts, K1, CHANNELS, CHANNELS // GROUPS),
                     dtype=wg.dtype, device=wg.device)
    stream = torch._C._cuda_getCurrentRawStream(wg.device.index)
    rc = _kernels()["split", wg.dtype](wg.data_ptr(), ws.data_ptr(), stream)
    if rc != 0:
        raise _launch_error(rc, f"split_weights for wg {wg.dtype}")
    split_weights.launches += 1
    return ws


split_weights.launches = 0


def _check(x, w0, b0, wg, b1, stride) -> None:
    if x.dim() != 3 or x.shape[2] != 1:
        raise ValueError(f"x must be (B, T, 1), got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scale_disc_head takes float32 or bfloat16, got "
                        f"{x.dtype}")
    for name, w, shape in (("w0", w0, (K0, 1, CHANNELS)),
                           ("wg", wg, (K1, CHANNELS // GROUPS, CHANNELS))):
        if tuple(w.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(w.shape)}")
    for name, b in (("b0", b0), ("b1", b1)):
        if b is not None and tuple(b.shape) != (CHANNELS,):
            raise ValueError(f"{name} must be ({CHANNELS},), got "
                             f"{tuple(b.shape)}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    for name, t in (("x", x), ("w0", w0), ("b0", b0), ("wg", wg), ("b1", b1)):
        if t is None:
            continue
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; x is "
                             f"{x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(x, w0, b0, wg, b1, stride, negative_slope):
    """Launch the prep kernel and the head on CUDA tensors that passed
    ``_check``."""
    if x.device.index != torch.cuda.current_device():
        # the kernels launch on the current device
        with torch.cuda.device(x.device):
            return _launch(x, w0, b0, wg, b1, stride, negative_slope)
    bsz, t, _ = x.shape
    h0 = torch.empty(bsz, t, CHANNELS, device=x.device, dtype=x.dtype)
    h1 = torch.empty(bsz, scale_disc_head_output_length(t, stride), CHANNELS,
                     device=x.device, dtype=x.dtype)
    if x.numel() == 0:
        return h0, h1
    ws = _split(wg)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    rc = _kernels()["head", x.dtype](
        x.data_ptr(), w0.data_ptr(), None if b0 is None else b0.data_ptr(),
        ws.data_ptr(), None if b1 is None else b1.data_ptr(), h0.data_ptr(),
        h1.data_ptr(), bsz, t, stride, negative_slope, stream)
    if rc != 0:
        raise _launch_error(rc, f"scale_disc_head kernel for x "
                                f"{tuple(x.shape)} {x.dtype}, stride {stride}")
    scale_disc_head.launches += 1
    scale_disc_head.launches_by_dtype[str(x.dtype)] += 1
    return h0, h1


class ScaleDiscHeadFunction(torch.autograd.Function):
    """Forward: ``_launch`` (the kernel). Backward: the plain version
    recomputed under autograd, differentiated with respect to every input
    that needs a gradient."""

    @staticmethod
    def forward(ctx, x, w0, b0, wg, b1, stride, negative_slope):
        ctx.save_for_backward(x, w0, b0, wg, b1)
        ctx.stride, ctx.negative_slope = stride, negative_slope
        return _launch(x, w0, b0, wg, b1, stride, negative_slope)

    @staticmethod
    def backward(ctx, g0, g1):
        return (*recompute_grads(scale_disc_head_plain, ctx.saved_tensors,
                                 ctx.needs_input_grad[:5], (g0, g1),
                                 stride=ctx.stride,
                                 negative_slope=ctx.negative_slope),
                None, None)


def scale_disc_head(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor | None,
                    wg: torch.Tensor, b1: torch.Tensor | None, *, stride: int,
                    negative_slope: float = 0.1
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scale-discriminator head. x ``(B, T, 1)`` contiguous, float32 or
    bfloat16; w0 ``(15, 1, 128)``; wg ``(41, 32, 128)``; b ``(128,)`` or
    None; all of x's dtype and device. Returns h0 ``(B, T, 128)`` and h1
    ``(B, (T - 1) // stride + 1, 128)``, differentiable in every input."""
    if x.device.type == "cpu":
        return scale_disc_head_plain(x, w0, b0, wg, b1, stride=stride,
                                     negative_slope=negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"scale_disc_head runs on cpu or cuda, not {x.device}")
    _check(x, w0, b0, wg, b1, stride)
    return ScaleDiscHeadFunction.apply(x, w0, b0, wg, b1, stride,
                                       negative_slope)


scale_disc_head.launches = 0
scale_disc_head.launches_by_dtype = collections.Counter()
