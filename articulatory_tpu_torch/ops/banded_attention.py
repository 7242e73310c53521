"""Banded self-attention with a learned relative-position table (Gaddy &
Klein's encoder attention), without the ``(B, H, L, L)`` logits.

For q, k, v ``(B, H, L, d)``, the table E ``(H, 2m - 1, d)`` and, in
training, a keep mask ``(B, H, L, 2m - 1)`` with dropout rate ``p``::

    s[i, j] = q_i . k_j / sqrt(d) + q_i . E[j - i + m - 1]   for |j - i| < m
    o_i     = sum_j softmax_j(s[i, :]) keep[i, j - i + m - 1] / (1 - p) v_j

The JAX package (``articulatory_tpu/layers/transformer.py``) and the port's
dense path (``layers/transformer.py::relative_position_logits``) build all
``(B, H, L, L)`` logits, gather the table clipped to distance ``m - 1``
and add ``-1e8`` where ``|j - i| >= m``. Dropping those entries is exact,
no approximation: such a logit is at most ``-1e8`` plus logits of order 1
to 100, so its ``exp(logit - max)`` underflows to exactly 0 in float32 and
in float64, and the row's maximum is finite because the diagonal ``j = i``
always lies inside the band. Its probability, its share of the output and
its gradient are all 0, so each query sees at most ``2m - 1`` keys (199 at
the published m = 100) and work and memory grow with ``L (2m - 1)``.

The keep mask is banded like the logits: entry ``[b, h, i, r]`` keeps the
probability of key ``j = i + r - (m - 1)``; entries whose key lies outside
``[0, L)`` are never read. The caller draws it (``layers/transformer.py``
from the training step's ``RandomDraws`` by tag), so a test or a reference
replays the same masks.

``banded_attention_plain`` is the function in plain PyTorch: query blocks
of ``PLAIN_BLOCK`` rows against their key windows, nothing of size L^2.
``banded_attention`` dispatches on the device: a CPU tensor goes to the
plain version and is differentiated by autograd; a CUDA tensor in float32
or bfloat16 launches the kernels (through ``BandedAttentionFunction``
where a gradient is wanted), which compute in float32 whatever the
storage type, and a CUDA tensor of any other type raises ``TypeError``
(a caller that wants float64 on the card calls the plain version itself,
as ``layers/transformer.py`` does). A traced call records the registered
op ``articulatory_tpu_torch::banded_attention`` (``_OP``) instead, as
``ops/resblock_pair.py`` does. ``banded_attention.launches`` counts the
forwards that ran the kernels and ``banded_attention_backward.launches``
their backwards (``launches_by_dtype`` apart), never while a call is
traced.

The kernels are CUDA C++ for Hopper in ``csrc/banded_attention.cu`` (its
header holds the design), built with nvcc by ``ops/_build.py`` and bound
through ctypes; the JAX package has no kernel here (it computes the
attention in plain ``jnp``). A forward is two launches,
``banded_attn_rel_kernel`` (R = q E^T into a ``(B H, L, 2m - 1)``
float32 scratch array) and ``banded_attn_fwd_kernel``; a backward four,
the first again, then ``banded_attn_bwd_q_kernel``,
``banded_attn_bwd_kv_kernel`` and ``banded_attn_bwd_table_kernel``, whose
partial sums of the table's gradient are added here in a fixed order.
Every product runs in 3xTF32 (each float32 operand split into a tf32 high
and low part, three tensor-core products), close to float32 accuracy, as
the port's other float32 kernels do; no atomics, so the gradients are
bit-equal from call to call.

What bounds it on the card: per query and head, ``2m - 1`` keys make 6
(2m - 1) d operations forward and 12 (2m - 1) d backward (the products
with k, v and E, their gradients); at d 96 and m 100 that is about 100
operations for each byte of q, k, v, o, their gradients and the mask, so
the 3xTF32 operation bound dominates
(``portbench/kernels/banded_attention.py``).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from articulatory_tpu_torch.ops import _build

# query rows a block of the plain version
PLAIN_BLOCK = 128
# the partial sums of the table's gradient (rows (b, i) split evenly)
TABLE_SPLITS = 64
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128


def band(table: torch.Tensor) -> tuple[int, int]:
    """(W, m - 1) of a table ``(H, W, d)``, W = 2m - 1."""
    w = table.shape[1]
    if w % 2 != 1:
        raise ValueError(f"the table holds 2m - 1 rows, got {w}")
    return w, (w - 1) // 2


def _plain(q, k, v, table, keep, p, block: int = PLAIN_BLOCK):
    """(o, the rows' log-sum-exp) in plain PyTorch, query block by query
    block."""
    b, h, length, d = q.shape
    w, half = band(table)
    scale = d ** -0.5
    outs, lses = [], []
    for q0 in range(0, length, block):
        q1 = min(q0 + block, length)
        k0, k1 = max(0, q0 - half), min(length, q1 + half)
        qb = q[:, :, q0:q1]
        s = torch.einsum("bhqd,bhkd->bhqk", qb, k[:, :, k0:k1]) * scale
        rel = (torch.arange(k0, k1, device=q.device)[None, :]
               - torch.arange(q0, q1, device=q.device)[:, None] + half)
        idx = rel.clamp(0, w - 1).expand(b, h, -1, -1)
        r = torch.einsum("bhqd,hwd->bhqw", qb, table)
        s = (s + r.gather(-1, idx)).masked_fill((rel < 0) | (rel >= w),
                                                float("-inf"))
        lses.append(torch.logsumexp(s, -1))
        prob = torch.softmax(s, -1)
        if keep is not None:
            prob = prob * keep[:, :, q0:q1].bool().gather(-1, idx) / (1 - p)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", prob, v[:, :, k0:k1]))
    return torch.cat(outs, 2), torch.cat(lses, 2)


def banded_attention_plain(q, k, v, table, keep=None, p: float = 0.0,
                           block: int = PLAIN_BLOCK) -> torch.Tensor:
    """o ``(B, H, L, d)`` in plain PyTorch (differentiable by autograd);
    each query block of ``block`` rows against its key window."""
    return _plain(q, k, v, table, keep, p, block)[0]


def _check(q, k, v, table, keep) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must be (B, H, L, d) alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    w, _ = band(table)
    if table.shape != (q.shape[1], w, q.shape[3]):
        raise ValueError(f"the table must be (H, 2m - 1, d), got "
                         f"{tuple(table.shape)} for q {tuple(q.shape)}")
    if keep is not None and (keep.shape != (*q.shape[:3], w)
                             or keep.dtype not in (torch.bool, torch.uint8)):
        raise ValueError(f"the keep mask must be (B, H, L, {w}) bool or "
                         f"uint8, got {tuple(keep.shape)} {keep.dtype}")
    for name, t in (("k", k), ("v", v), ("table", table), ("keep", keep)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _check_kernel(q, k, v, table) -> None:
    """What the kernels need besides."""
    if q.dtype not in KERNEL_DTYPES or any(t.dtype != q.dtype
                                           for t in (k, v, table)):
        raise TypeError(f"the kernels take q, k, v and the table alike in "
                        f"one of {KERNEL_DTYPES}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {table.dtype}; banded_attention_plain "
                        f"computes any other type")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"the kernels take d up to {MAX_HEAD_DIM}, got "
                         f"{q.shape[3]}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t with unit stride along its last axis (the kernels' d)."""
    return t if t.stride(-1) == 1 else t.contiguous()


@functools.cache
def _library() -> ctypes.CDLL:
    """``csrc/banded_attention.cu``'s library, its entries typed."""
    lib = _build.library("banded_attention")
    i64, ptr = ctypes.c_longlong, ctypes.c_void_p
    lib.banded_attention_forward.argtypes = (
        [ctypes.c_int] + [ptr] * 8 + [i64] * 9 + [ctypes.c_int] * 5
        + [ctypes.c_float, ptr])
    lib.banded_attention_backward.argtypes = (
        [ctypes.c_int] + [ptr] * 15 + [i64] * 12 + [ctypes.c_int] * 7
        + [ctypes.c_float, ptr])
    for fn in (lib.banded_attention_forward, lib.banded_attention_backward):
        fn.restype = ctypes.c_int
    lib.banded_attention_error_string.argtypes = [ctypes.c_int]
    lib.banded_attention_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, what: str, q: torch.Tensor) -> None:
    if rc != 0:
        msg = _library().banded_attention_error_string(rc).decode()
        raise RuntimeError(f"{what} did not launch for q {tuple(q.shape)} "
                           f"{q.dtype}: CUDA error {rc} ({msg})")


def _mask(keep) -> int | None:
    """The kernels' keep pointer: the mask as uint8, or null."""
    return None if keep is None else keep.contiguous().view(
        torch.uint8).data_ptr()


def _common(q, k, v, table, keep):
    """The pointers both entries take first, after the dtype."""
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
            _mask(keep))


def _launch(q, k, v, table, keep, p):
    """(o, the rows' log-sum-exp) from the forward kernels, on CUDA
    tensors that passed ``_check`` and ``_check_kernel``."""
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return _launch(q, k, v, table, keep, p)
    q, k, v = (_rows(t) for t in (q, k, v))
    table = table.contiguous()
    b, h, length, d = q.shape
    w, _ = band(table)
    o = torch.empty((b, h, length, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, length), device=q.device, dtype=torch.float32)
    if q.numel():
        keep = None if keep is None else keep.contiguous()
        r = _scratch(q, w)
        rc = _library().banded_attention_forward(
            KERNEL_DTYPES.index(q.dtype), *_common(q, k, v, table, keep),
            o.data_ptr(), lse.data_ptr(), r.data_ptr(), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], b, h, length, d, w,
            1.0 / (1.0 - p), torch.cuda.current_stream().cuda_stream)
        _raise_on(rc, "the banded attention's forward kernels", q)
    banded_attention.launches += 1
    banded_attention.launches_by_dtype[str(q.dtype)] += 1
    return o, lse


def _launch_backward(q, k, v, table, keep, p, o, lse, do):
    """[dq, dk, dv, dtable] from the backward kernels."""
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return _launch_backward(q, k, v, table, keep, p, o, lse, do)
    q, k, v, do = (_rows(t) for t in (q, k, v, do))
    table, o = table.contiguous(), o.contiguous()
    b, h, length, d = q.shape
    w, _ = band(table)
    dev = q.device
    dq, dk, dv = (torch.empty((b, h, length, d), device=dev, dtype=q.dtype)
                  for _ in range(3))
    rows = b * length
    per_split = max(1, _cdiv(rows, TABLE_SPLITS))
    splits = _cdiv(rows, per_split)
    part = torch.zeros((max(splits, 1), h, w, d), device=dev,
                       dtype=torch.float32)
    if q.numel():
        keep = None if keep is None else keep.contiguous()
        # R, dS and the kept probabilities over the band
        r, dr, pd = (_scratch(q, w) for _ in range(3))
        rc = _library().banded_attention_backward(
            KERNEL_DTYPES.index(q.dtype), *_common(q, k, v, table, keep),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dr.data_ptr(), pd.data_ptr(),
            part.data_ptr(), r.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *do.stride()[:3], b, h, length, d, w, splits,
            per_split, 1.0 / (1.0 - p),
            torch.cuda.current_stream().cuda_stream)
        _raise_on(rc, "the banded attention's backward kernels", q)
    return [dq, dk, dv, part.sum(0).to(table.dtype)]


def _scratch(q: torch.Tensor, w: int) -> torch.Tensor:
    """A float32 array over the band, ``(B H, L, W)``."""
    b, h, length, _ = q.shape
    return torch.empty((b * h, length, w), device=q.device,
                       dtype=torch.float32)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def banded_attention_backward(q, k, v, table, keep, p, o, lse, do,
                              needs=(True,) * 4) -> list:
    """[dq, dk, dv, dtable] for ``do = dL/do``, None where ``needs`` is off:
    the kernels on a CUDA tensor (counted in ``launches``), on a CPU tensor
    the plain version recomputed under autograd and differentiated."""
    if q.device.type == "cpu":
        from articulatory_tpu_torch.ops._recompute import recompute_grads
        return recompute_grads(banded_attention_plain, (q, k, v, table),
                               needs, do, keep=keep, p=p)
    grads = _launch_backward(q, k, v, table, keep, p, o, lse, do)
    banded_attention_backward.launches += 1
    banded_attention_backward.launches_by_dtype[str(q.dtype)] += 1
    return [g if n else None for g, n in zip(grads, needs)]


banded_attention_backward.launches = 0
banded_attention_backward.launches_by_dtype = collections.Counter()


class BandedAttentionFunction(torch.autograd.Function):
    """Forward: ``_launch`` (o and the rows' log-sum-exp, which takes no
    gradient). Backward: ``banded_attention_backward``. The op's autograd
    is the same backward."""

    @staticmethod
    def forward(ctx, q, k, v, table, keep, p):
        o, lse = _launch(q, k, v, table, keep, p)
        ctx.save_for_backward(q, k, v, table, keep, o, lse)
        ctx.p = p
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _):
        q, k, v, table, keep, o, lse = ctx.saved_tensors
        grads = banded_attention_backward(q, k, v, table, keep, ctx.p, o,
                                          lse, do, ctx.needs_input_grad[:4])
        return (*grads, None, None)


# A registered op, so that tracing keeps the attention as one node, beside
# ``resblock_pair`` in the port's namespace (a fragment of its library)
_LIB = torch.library.Library("articulatory_tpu_torch", "FRAGMENT")
_LIB.define("banded_attention(Tensor q, Tensor k, Tensor v, Tensor table, "
            "Tensor? keep, float p) -> (Tensor, Tensor)")


def _op_cuda(q, k, v, table, keep, p):
    _check(q, k, v, table, keep)
    _check_kernel(q, k, v, table)
    return _launch(q, k, v, table, keep, p)


def _op_cpu(q, k, v, table, keep, p):
    return _plain(q, k, v, table, keep, p)


def _op_fake(q, k, v, table, keep, p):
    _check(q, k, v, table, keep)
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty(q.shape[:3], dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    q, k, v, table, keep, p = inputs
    ctx.save_for_backward(q, k, v, table, keep, *output)
    ctx.p = p


_LIB.impl("banded_attention", _op_cuda, "CUDA")
_LIB.impl("banded_attention", _op_cpu, "CPU")
torch.library.register_fake("articulatory_tpu_torch::banded_attention",
                            _op_fake, lib=_LIB)
torch.library.register_autograd("articulatory_tpu_torch::banded_attention",
                                BandedAttentionFunction.backward,
                                setup_context=_setup_context, lib=_LIB)
_OP = torch.ops.articulatory_tpu_torch.banded_attention.default


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     table: torch.Tensor, keep: torch.Tensor | None = None,
                     p: float = 0.0) -> torch.Tensor:
    """o ``(B, H, L, d)`` of banded attention with the relative table
    ``(H, 2m - 1, d)``; ``keep`` the banded keep mask ``(B, H, L, 2m - 1)``
    (bool or uint8) and ``p`` the dropout rate, or None for no dropout.
    Differentiable in q, k, v and the table. On the card q, k, v and the
    table are float32 or bfloat16 (else ``TypeError``). A traced call
    records the op."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"banded_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if torch.compiler.is_compiling():
        return _OP(q, k, v, table, keep, float(p))[0]
    _check(q, k, v, table, keep)
    if q.device.type == "cpu":
        return banded_attention_plain(q, k, v, table, keep, p)
    _check_kernel(q, k, v, table)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k, v, table)):
        return BandedAttentionFunction.apply(q, k, v, table, keep, p)[0]
    return _launch(q, k, v, table, keep, p)[0]


banded_attention.launches = 0
banded_attention.launches_by_dtype = collections.Counter()
