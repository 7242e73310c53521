"""Fused HiFi-GAN residual pair: ``y = x + conv2(lrelu(conv1(lrelu(x), d)))``.

Replaces ``articulatory_tpu/ops/pallas/resblock.py::resblock_pair_pallas``
(the TPU kernel) with ``csrc/resblock_pair.cu``, one tensor-core (wgmma)
kernel template for Hopper (``sm_90a``) bound through ctypes, which keeps the
intermediate ``h`` in shared memory and sums in f32 (see the source for the
design). bfloat16 runs wgmma on bf16 operands. float32 (the parity mode) runs
3xTF32: each operand is split into two tf32 values (``a = a_hi + a_lo``) and
each product is ``a_lo b_hi + a_hi b_lo + a_hi b_hi``, close to f32 accuracy.
wgmma reads 32-bit weights only K-major, so the f32 weights go through a
prep kernel first (``split_tf32``: (tap, in, out) into (2, tap, out, in), hi
then lo); ``split_tf32_plain`` is the same split in PyTorch. The split is
cached on inference tensors (the decode's kernels, folded once under
``torch.inference_mode`` after ``remove_weight_norm`` and never changed after)
and on an exported program's constants (``export.py``), and made in every
call otherwise (training refolds its weights each forward).
The kernel takes C up to 256, a multiple of 16 in bf16 and of 8 in f32:
``_launch`` zero-pads other C (``pad_channels``, exact) and slices the
result; a wider C raises.

``resblock_pair`` dispatches on the tensor's device: a CPU tensor goes to
``resblock_pair_plain``, the same function in plain PyTorch; a CUDA tensor
launches the kernel (through ``ResblockPairFunction`` where a gradient is
wanted) or raises. A traced call (``torch.export``, ``export.py``) records
the registered op ``articulatory_tpu_torch::resblock_pair`` (``_OP``)
instead, on either device: its CUDA kernel is ``_launch``, its CPU kernel
the plain pair, its fake kernel gives x's shape and dtype, its backward the
Function's. Eager calls skip the op's
dispatcher, whose Python autograd layer would add host time to every launch.
``resblock_pair.launches`` counts the pair's launches as they run
(``launches_by_dtype`` apart per dtype name), never while a call is traced;
``split_tf32.launches`` the prep kernel's.

Gradients: the JAX package has no backward for this kernel (its models
differentiate through XLA convs). The backward recomputes
``resblock_pair_plain`` under autograd and differentiates it
(``ops/_recompute.py``), one extra plain forward and no intermediate
activation kept. ``_launch`` is a module function, so a test can stand the
plain version in for the kernel.
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


# widest C the kernel takes, and the multiple it takes C in per dtype
MAX_CHANNELS = 256
BF16_CHANNEL_MULTIPLE = 16
F32_CHANNEL_MULTIPLE = 8
_CHANNEL_MULTIPLE = {torch.bfloat16: BF16_CHANNEL_MULTIPLE,
                     torch.float32: F32_CHANNEL_MULTIPLE}


def round_tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 to the nearest tf32 value (10 mantissa bits, ties away from
    zero, as ``cvt.rna.tf32.f32``), kept in float32: the low 13 bits of the
    pattern cleared after adding half of their range to the magnitude."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32_plain(w: torch.Tensor) -> torch.Tensor:
    """The prep kernel's function in PyTorch: w ``(K, C_in, C_out)`` float32
    into ``(2, K, C_out, C_in)``, [0] ``hi = tf32(w)``, [1]
    ``lo = tf32(w - hi)``, each transposed to (tap, out, in)."""
    wt = w.transpose(1, 2)
    hi = round_tf32(wt)
    return torch.stack((hi, round_tf32(wt - hi)))


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
def _kernels() -> dict[torch.dtype | str, ctypes._CFuncPtr]:
    """The pair's entry per dtype, and the prep kernel's ("split_tf32")."""
    lib = _build.library("resblock_pair")
    out = {}
    for dtype, name in ((torch.float32, "resblock_pair_f32"),
                        (torch.bfloat16, "resblock_pair_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[dtype] = fn
    split = lib.resblock_pair_split_tf32
    split.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    split.restype = ctypes.c_int
    out["split_tf32"] = split
    lib.resblock_pair_error_string.argtypes = [ctypes.c_int]
    lib.resblock_pair_error_string.restype = ctypes.c_char_p
    return out


def _launch_error(rc: int, what: str) -> RuntimeError:
    msg = _build.library("resblock_pair").resblock_pair_error_string(rc)
    return RuntimeError(f"{what} did not launch: CUDA error {rc} "
                        f"({msg.decode()})")


def split_tf32(w1: torch.Tensor, w2: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``split_tf32_plain`` of w1 ``(K1, C, C)`` and w2 ``(K2, C, C)``,
    float32: on CUDA tensors one launch of the prep kernel, on CPU tensors
    the plain version."""
    if w1.device.type == "cpu":
        return split_tf32_plain(w1), split_tf32_plain(w2)
    c = w1.shape[1]
    for name, w in (("w1", w1), ("w2", w2)):
        if (w.dtype != torch.float32 or w.device != w1.device or w.dim() != 3
                or w.shape[1:] != (c, c) or not w.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 (K, {c}, "
                             f"{c}) on {w1.device}, got {w.dtype} "
                             f"{tuple(w.shape)} on {w.device}")
    return _split(w1, w2)


def _split(w1, w2):
    """The prep kernel's launch on weights already checked."""
    c = w1.shape[1]
    s1 = torch.empty((2, *w1.shape), dtype=torch.float32, device=w1.device)
    s2 = torch.empty((2, *w2.shape), dtype=torch.float32, device=w1.device)
    stream = torch._C._cuda_getCurrentRawStream(w1.device.index)
    rc = _kernels()["split_tf32"](w1.data_ptr(), w2.data_ptr(), s1.data_ptr(),
                                  s2.data_ptr(), c, w1.shape[0], w2.shape[0],
                                  stream)
    if rc != 0:
        raise _launch_error(rc, f"split_tf32 for w1 {tuple(w1.shape)}, w2 "
                                f"{tuple(w2.shape)}")
    split_tf32.launches += 1
    return s1, s2


split_tf32.launches = 0


# the flag ``export.py`` sets on the tensors a program holds as constants
CONSTANT = "_program_constant"


def _weight_splits(w1, w2):
    """The tf32 splits of w1 and w2: cached on each weight that is an
    inference tensor (which cannot change outside inference mode, and which
    the decode never changes in it) or an exported program's constant
    (``CONSTANT``), made by the prep kernel otherwise."""
    cached = [getattr(w, "_tf32_split", None) for w in (w1, w2)]
    if cached[0] is not None and cached[1] is not None:
        return cached
    splits = _split(w1, w2)
    for w, s in zip((w1, w2), splits):
        if w.is_inference() or getattr(w, CONSTANT, False):
            w._tf32_split = s
    return splits


def _check_shapes(x, w1, b1, w2, b2, dilation) -> None:
    """What every kernel of the op needs: the shapes and the dilation."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got shape {tuple(x.shape)}")
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


def _check(x, w1, b1, w2, b2, dilation) -> None:
    """What the CUDA kernel needs besides."""
    _check_shapes(x, w1, b1, w2, b2, dilation)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"resblock_pair takes float32 or bfloat16, got {x.dtype}")
    c = x.shape[2]
    if c > MAX_CHANNELS:
        raise ValueError(f"the kernel takes at most {MAX_CHANNELS} channels, "
                         f"got {c}")
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
    multiple = _CHANNEL_MULTIPLE[x.dtype]
    if c % multiple:
        padded = pad_channels(x, w1, b1, w2, b2, multiple)
        return _launch(*padded, dilation,
                       negative_slope)[..., :c].contiguous()
    if x.device.index != torch.cuda.current_device():
        # the kernel launches on the current device
        with torch.cuda.device(x.device):
            return _launch(x, w1, b1, w2, b2, dilation, negative_slope)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    k1, k2 = w1.shape[0], w2.shape[0]
    if x.dtype == torch.float32:
        w1, w2 = _weight_splits(w1, w2)
    fn = _kernels()[x.dtype]
    bsz, t, c = x.shape
    # the raw handle: torch.cuda.current_stream() builds a Stream object on
    # every call
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    rc = fn(x.data_ptr(), w1.data_ptr(),
            None if b1 is None else b1.data_ptr(), w2.data_ptr(),
            None if b2 is None else b2.data_ptr(), y.data_ptr(),
            bsz, t, c, k1, k2, dilation, negative_slope, stream)
    if rc != 0:
        raise _launch_error(rc, f"resblock_pair kernel for x {tuple(x.shape)} "
                                f"{x.dtype}, K ({k1}, {k2}), dilation "
                                f"{dilation}")
    resblock_pair.launches += 1
    resblock_pair.launches_by_dtype[str(x.dtype)] += 1
    return y


class ResblockPairFunction(torch.autograd.Function):
    """Forward: ``_launch`` (the kernel). Backward: the plain pair
    recomputed under autograd, differentiated with respect to every input
    that needs a gradient. The op's autograd is the same backward."""

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


# A registered op, so that tracing keeps the pair as one node of the graph.
# Its kernels are plain Python functions on the dispatcher (``Library.impl``:
# no ``custom_op`` wrapper, whose alias checks cost host time every call)
# that look ``_launch`` and ``resblock_pair_plain`` up when they run, so a
# test can stand the plain version in for the launch.
_LIB = torch.library.Library("articulatory_tpu_torch", "DEF")
_LIB.define("resblock_pair(Tensor x, Tensor w1, Tensor? b1, Tensor w2, "
            "Tensor? b2, int dilation, float negative_slope) -> Tensor")


def _op_cuda(x, w1, b1, w2, b2, dilation, negative_slope):
    _check(x, w1, b1, w2, b2, dilation)
    return _launch(x, w1, b1, w2, b2, dilation, negative_slope)


def _op_cpu(x, w1, b1, w2, b2, dilation, negative_slope):
    return resblock_pair_plain(x, w1, b1, w2, b2, dilation=dilation,
                               negative_slope=negative_slope)


def _op_fake(x, w1, b1, w2, b2, dilation, negative_slope):
    _check_shapes(x, w1, b1, w2, b2, dilation)
    return torch.empty_like(x)


def _setup_context(ctx, inputs, output):
    x, w1, b1, w2, b2, dilation, negative_slope = inputs
    ctx.save_for_backward(x, w1, b1, w2, b2)
    ctx.dilation, ctx.negative_slope = dilation, negative_slope


_LIB.impl("resblock_pair", _op_cuda, "CUDA")
_LIB.impl("resblock_pair", _op_cpu, "CPU")
torch.library.register_fake("articulatory_tpu_torch::resblock_pair",
                            _op_fake, lib=_LIB)
torch.library.register_autograd("articulatory_tpu_torch::resblock_pair",
                                ResblockPairFunction.backward,
                                setup_context=_setup_context, lib=_LIB)
_OP = torch.ops.articulatory_tpu_torch.resblock_pair.default


def resblock_pair(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor | None,
                  w2: torch.Tensor, b2: torch.Tensor | None, *, dilation: int,
                  negative_slope: float = 0.1) -> torch.Tensor:
    """Fused residual pair. x ``(B, T, C)`` contiguous, float32 or bfloat16;
    w1 ``(K1, C, C)``, w2 ``(K2, C, C)`` folded, (in, out) order, K odd;
    b ``(C,)`` or None; all of x's dtype and device. Differentiable in
    every tensor input. A traced call records the op."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"resblock_pair runs on cpu or cuda, not {x.device}")
    if torch.compiler.is_compiling():
        return _OP(x, w1, b1, w2, b2, dilation, negative_slope)
    if x.device.type == "cpu":
        return resblock_pair_plain(x, w1, b1, w2, b2, dilation=dilation,
                                   negative_slope=negative_slope)
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
resblock_pair.launches_by_dtype = collections.Counter()
