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
differentiate through XLA convs). ``ResblockPairFunction.backward`` calls
``resblock_pair_backward``: on a CPU tensor ``resblock_pair_backward_plain``
(the gradients' formulas in plain PyTorch); on a float32 CUDA tensor
``_launch_backward``, the hand kernels of ``csrc/resblock_pair_backward.cu``
(3xTF32 wgmma: h recomputed in the kernel, the data gradient as the
forward's implicit GEMMs, the weight gradient split over rows with partial
sums added in a fixed order, so bit-equal from call to call; an h within
the sums' error of 0 takes its lrelu' from an exact f64 sum), which compute
only the gradients asked for (none of the weights' for frozen weights) and
zero-pad C as ``_launch`` does; a bfloat16 CUDA tensor still recomputes
``resblock_pair_plain`` under autograd and differentiates it
(``ops/_recompute.py``). ``resblock_pair_backward.
launches`` counts the kernels' backwards (``launches_by_dtype`` apart).
``_launch`` and ``_launch_backward`` are module functions, so a test can
stand the plain versions in for the kernels.
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


def resblock_pair_backward_plain(x, w1, b1, w2, b2, gy, *, dilation: int,
                                 negative_slope: float = 0.1,
                                 needs=(True,) * 5) -> list:
    """The pair's gradients in plain PyTorch, from its inputs and gy =
    dL/dy: ``[dx, dw1, db1, dw2, db2]``, None where ``needs`` (one flag per
    input, as ``ctx.needs_input_grad``) is off or the bias is None. For
    ``a = lrelu(x)``, ``h = conv1(a) + b1``, ``g = lrelu(h)``:
    ``dg = conv2^T(gy)``, ``dh = dg lrelu'(h)``, ``dx = gy + lrelu'(x)
    conv1^T(dh)``, ``dw2[k] = sum g[t + k - p2]^T gy[t]``, ``dw1[k] = sum
    a[t + (k - p1) d]^T dh[t]``, ``db2 = sum gy``, ``db1 = sum dh``, rows
    outside [0, T) zero. lrelu'(v) is 1 where v > 0, else the slope (as
    PyTorch's leaky_relu backward)."""
    k1, k2 = w1.shape[0], w2.shape[0]
    p1, p2 = (k1 - 1) // 2 * dilation, (k2 - 1) // 2
    t = x.shape[1]
    slope = torch.tensor(negative_slope, dtype=x.dtype)
    a = F.leaky_relu(x, negative_slope)
    h = conv1d(a, w1, b1, padding=p1, dilation=dilation)
    dg = conv1d(gy, w2.flip(0).transpose(1, 2), None, padding=p2)
    dh = dg * torch.where(h > 0, 1, slope)
    need_x, need_w1, need_b1, need_w2, need_b2 = (
        n and v is not None for n, v in zip(needs, (x, w1, b1, w2, b2)))
    dx = dw1 = db1 = dw2 = db2 = None
    if need_x:
        da = conv1d(dh, w1.flip(0).transpose(1, 2), None, padding=p1,
                    dilation=dilation)
        dx = gy + torch.where(x > 0, 1, slope) * da
    if need_w1:
        ap = F.pad(a, (0, 0, p1, p1))
        dw1 = torch.stack([torch.einsum("bti,bto->io",
                                        ap[:, j * dilation:j * dilation + t], dh)
                           for j in range(k1)])
    if need_w2:
        gp = F.pad(F.leaky_relu(h, negative_slope), (0, 0, p2, p2))
        dw2 = torch.stack([torch.einsum("bti,bto->io", gp[:, j:j + t], gy)
                           for j in range(k2)])
    if need_b1:
        db1 = dh.sum((0, 1))
    if need_b2:
        db2 = gy.sum((0, 1))
    return [dx, dw1, db1, dw2, db2]


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


@functools.cache
def _backward_kernels() -> dict[str, ctypes._CFuncPtr]:
    """The backward's entry ("f32") and its workspace query."""
    lib = _build.library("resblock_pair_backward")
    fn = lib.resblock_pair_backward_f32
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_size_t] + [
        ctypes.c_int] * 6 + [ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.resblock_pair_backward_workspace
    size.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_size_t)]
    size.restype = ctypes.c_int
    return {"f32": fn, "workspace": size}


@functools.lru_cache(maxsize=1024)
def _backward_workspace(device: int, *shape) -> int:
    """Bytes of workspace the backward takes at ``shape`` (batch, T, C, k1,
    k2, dilation, need_w1, need_w2) on ``device``, the current one."""
    size = ctypes.c_size_t(0)
    rc = _backward_kernels()["workspace"](*shape, ctypes.byref(size))
    if rc != 0:
        raise _launch_error(rc, f"resblock_pair backward plan for {shape}")
    return size.value


def _launch_backward(x, w1, b1, w2, b2, gy, dilation, negative_slope,
                     needs) -> list:
    """The backward kernels on float32 CUDA tensors that passed ``_check``:
    ``[dx, dw1, db1, dw2, db2]`` as ``resblock_pair_backward_plain``."""
    needs = [n and v is not None for n, v in zip(needs, (x, w1, b1, w2, b2))]
    c = x.shape[2]
    if c % F32_CHANNEL_MULTIPLE:
        padded = pad_channels(x, w1, b1, w2, b2, F32_CHANNEL_MULTIPLE)
        grads = _launch_backward(*padded, F.pad(gy, (0, padded[0].shape[2] - c)),
                                 dilation, negative_slope, needs)
        cut = (lambda g: g[..., :c], lambda g: g[:, :c, :c], lambda g: g[:c])
        return [None if g is None else cut[kind](g).contiguous()
                for g, kind in zip(grads, (0, 1, 2, 1, 2))]
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _launch_backward(x, w1, b1, w2, b2, gy, dilation,
                                    negative_slope, needs)
    gy = gy.contiguous()
    made = [torch.empty_like(v) if n else None
            for n, v in zip(needs, (x, w1, b1, w2, b2))]
    if x.numel() == 0:
        return [None if g is None else g.zero_() for g in made]
    bsz, t, _ = x.shape
    k1, k2 = w1.shape[0], w2.shape[0]
    need_w1, need_w2 = needs[1] or needs[2], needs[3] or needs[4]
    shape = (bsz, t, c, k1, k2, dilation, int(need_w1), int(need_w2))
    ws = torch.empty(_backward_workspace(x.device.index, *shape),
                     dtype=torch.uint8, device=x.device)
    ptr = [None if g is None else g.data_ptr() for g in made]
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    rc = _backward_kernels()["f32"](
        x.data_ptr(), gy.data_ptr(), w1.data_ptr(),
        None if b1 is None else b1.data_ptr(), w2.data_ptr(), *ptr,
        ws.data_ptr(), ws.numel(), bsz, t, c, k1, k2, dilation,
        negative_slope, stream)
    if rc != 0:
        raise _launch_error(rc, f"resblock_pair backward for x "
                                f"{tuple(x.shape)}, K ({k1}, {k2}), "
                                f"dilation {dilation}")
    return made


def resblock_pair_backward(x, w1, b1, w2, b2, gy, *, dilation: int,
                           negative_slope: float = 0.1,
                           needs=(True,) * 5) -> list:
    """The pair's gradients ``[dx, dw1, db1, dw2, db2]`` (None where not
    needed), as ``resblock_pair_backward_plain``: a CPU tensor runs that; a
    float32 CUDA tensor the backward kernels (counted in ``launches``); any
    other raises."""
    if x.device.type == "cpu":
        return resblock_pair_backward_plain(
            x, w1, b1, w2, b2, gy, dilation=dilation,
            negative_slope=negative_slope, needs=needs)
    _check(x, w1, b1, w2, b2, dilation)
    if x.dtype != torch.float32 or gy.shape != x.shape or gy.dtype != x.dtype:
        raise TypeError(f"the backward kernels take float32 x and gy of x's "
                        f"shape, got x {x.dtype}, gy {gy.dtype} "
                        f"{tuple(gy.shape)}")
    grads = _launch_backward(x, w1, b1, w2, b2, gy, dilation, negative_slope,
                             needs)
    resblock_pair_backward.launches += 1
    resblock_pair_backward.launches_by_dtype[str(x.dtype)] += 1
    return grads


resblock_pair_backward.launches = 0
resblock_pair_backward.launches_by_dtype = collections.Counter()


class ResblockPairFunction(torch.autograd.Function):
    """Forward: ``_launch`` (the kernel). Backward: ``resblock_pair_backward``
    for the inputs that need a gradient (the backward kernels on a float32
    CUDA tensor, the plain gradients on a CPU tensor); a bfloat16 CUDA
    tensor recomputes the plain pair under autograd and differentiates it.
    The op's autograd is the same backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, dilation, negative_slope):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.dilation, ctx.negative_slope = dilation, negative_slope
        return _launch(x, w1, b1, w2, b2, dilation, negative_slope)

    @staticmethod
    def backward(ctx, gy):
        saved, needs = ctx.saved_tensors, ctx.needs_input_grad[:5]
        kwargs = dict(dilation=ctx.dilation, negative_slope=ctx.negative_slope)
        if saved[0].is_cuda and saved[0].dtype == torch.bfloat16:
            grads = recompute_grads(resblock_pair_plain, saved, needs, gy,
                                    **kwargs)
        else:
            grads = resblock_pair_backward(*saved, gy, needs=needs, **kwargs)
        return (*grads, None, None)


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
