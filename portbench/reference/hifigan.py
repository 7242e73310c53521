"""Plain PyTorch reference of the HiFi-CAR generator (HiFi-GAN,
arXiv:2010.05646, with the CARGAN past encoder of the articulatory
recipes).

Functions of a state dict under the recipe's torch parameter names, over
channel-first ``(B, C, T)`` tensors with ``torch.nn.functional`` only. Weight
norm is ``g * v / ||v||`` over every axis but the first. ``precision``:

- ``f32``: every layer in float32 (TF32 off: ``no_tf32``); ``f64`` in
  float64, for the tests;
- ``bf16``: every convolution in bfloat16, the past encoder float32;
- ``hybrid``: the upsampling stages but the last in bfloat16; the input
  conv, the last stage and the output conv float32;
- ``hybrid-fp8``: as ``hybrid`` with e4m3 (``Fmt("fp8")``) in place of
  bfloat16, the hybrid cell's control.

Every activation, convolution, residual add and block sum rounds to its
stage's format; the output is float32. The hybrid split is the port's
documented ``hybrid_precision``: the stages that feed the AR carry stay
float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and matmuls in full float32 for the block."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def _conv_shapes(prefix: str, c_out: int, c_in: int, k, norm: bool,
                 bias: bool = True) -> dict:
    k = tuple(k) if isinstance(k, (tuple, list)) else (k,)
    shapes = ({f"{prefix}.weight_g": (c_out,) + (1,) * (len(k) + 1),
               f"{prefix}.weight_v": (c_out, c_in) + k} if norm
              else {f"{prefix}.weight": (c_out, c_in) + k})
    if bias:
        shapes[f"{prefix}.bias"] = (c_out,)
    return shapes


def generator_shapes(gp: dict) -> dict:
    """name -> shape of the generator's parameters."""
    norm = gp.get("use_weight_norm", True)
    ch, k = gp["channels"], gp["kernel_size"]
    shapes = {}
    if gp.get("use_ar", False):
        dims = [gp["ar_input"]] + [gp["ar_hidden"]] * 4 + [gp["ar_output"]]
        for i in range(5):
            shapes[f"ar_model.model.{2 * i}.weight"] = (dims[i + 1], dims[i])
            shapes[f"ar_model.model.{2 * i}.bias"] = (dims[i + 1],)
    shapes.update(_conv_shapes("input_conv", ch, gp["in_channels"], k, norm))
    n_blocks = len(gp["resblock_kernel_sizes"])
    for i, (s, uk) in enumerate(zip(gp["upsample_scales"],
                                    gp["upsample_kernel_sizes"])):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        # a transposed conv's weight is (C_in, C_out, K); its norm is over
        # the input channel
        shapes.update(_conv_shapes(f"upsamples.{i}.1", c_in, c_out, uk, norm,
                                   False))
        shapes[f"upsamples.{i}.1.bias"] = (c_out,)
        for j, (rk, dil) in enumerate(zip(gp["resblock_kernel_sizes"],
                                          gp["resblock_dilations"])):
            for d in range(len(dil)):
                for name in ("convs1", "convs2"):
                    shapes.update(_conv_shapes(
                        f"blocks.{i * n_blocks + j}.{name}.{d}.1", c_out,
                        c_out, rk, norm, gp.get("bias", True)))
    shapes.update(_conv_shapes("output_conv.1",
                               gp.get("out_channels", 1),
                               ch // 2 ** len(gp["upsample_scales"]), k, norm))
    return shapes


def weight(w: dict, prefix: str) -> torch.Tensor:
    """The effective kernel of ``prefix`` (weight norm folded)."""
    if f"{prefix}.weight_v" in w:
        v, g = w[f"{prefix}.weight_v"], w[f"{prefix}.weight_g"]
        return g * v / v.square().sum(dim=tuple(range(1, v.dim())),
                                      keepdim=True).sqrt()
    return w[f"{prefix}.weight"]


class Fmt:
    """A number format: ``fmt(t)`` rounds t to it; convolutions in it run
    in ``fmt.compute``. float32, float64 and bfloat16 are the library's
    types (a bfloat16 convolution sums in float32 and rounds its output).
    ``fp8`` is e4m3 with one scale a tensor (its largest magnitude at 448),
    computed in float32 from rounded operands and rounded again."""

    def __init__(self, kind):
        self.kind = kind
        self.compute = torch.float32 if kind == "fp8" else kind

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind != "fp8":
            return t.to(self.kind)
        t = t.float()
        scale = t.abs().amax().clamp(min=1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def up(self, t: torch.Tensor) -> torch.Tensor:
        """t where an activation is taken: float64 in float64, else
        float32."""
        return t.double() if self.kind == torch.float64 else t.float()

    def conv(self, conv, x, w, b, **kw):
        return self(conv(self(x).to(self.compute),
                         self(w).to(self.compute),
                         None if b is None else self(b).to(self.compute),
                         **kw))


def formats(gp: dict, precision: str) -> tuple[Fmt, list]:
    """(the format of the input and output convs, that of each upsampling
    stage)."""
    n = len(gp["upsample_scales"])
    kind = {"f32": torch.float32, "f64": torch.float64,
            "bf16": torch.bfloat16}.get(precision)
    if kind is not None:
        return Fmt(kind), [Fmt(kind)] * n
    inner = {"hybrid": torch.bfloat16, "hybrid-fp8": "fp8"}.get(precision)
    if inner is None:
        raise ValueError(f"unknown precision {precision!r}")
    return Fmt(torch.float32), [Fmt(inner)] * (n - 1) + [Fmt(torch.float32)]


def stage_dtypes(gp: dict, precision: str) -> tuple[object, list]:
    """The formats' kinds (``formats``)."""
    head, stages = formats(gp, precision)
    return head.kind, [f.kind for f in stages]


def past_encoder(w: dict, ar: torch.Tensor) -> torch.Tensor:
    """(B, P) past samples -> (B, ar_output), in ar's float type."""
    x = ar
    for i in range(5):
        x = F.linear(x, w[f"ar_model.model.{2 * i}.weight"],
                     w[f"ar_model.model.{2 * i}.bias"])
        if i < 4:
            x = F.leaky_relu(x, 0.1)
    return x


def generator(w: dict, gp: dict, c: torch.Tensor, ar: torch.Tensor | None,
              precision: str = "f32") -> torch.Tensor:
    """Features ``(B, T, F)`` and past samples ``(B, P)`` -> waveform
    ``(B, T * prod(upsample_scales))``, float32 (float64 in ``f64``)."""
    slope = gp.get("nonlinear_activation_params", {}).get(
        "negative_slope", 0.1)
    head, stages = formats(gp, precision)
    out_dt = torch.float64 if precision == "f64" else torch.float32
    x = c.transpose(1, 2).to(out_dt)
    if gp.get("use_ar", False):
        feats = past_encoder(w, ar.to(out_dt))
        x = torch.cat([x, feats[:, :, None].expand(-1, -1, x.shape[2])], 1)
    k = gp["kernel_size"]

    def conv(f, x, prefix, **kw):
        return f.conv(F.conv1d, x, weight(w, prefix), w.get(f"{prefix}.bias"),
                      **kw)

    x = conv(head, x, "input_conv", padding=(k - 1) // 2)
    n_blocks = len(gp["resblock_kernel_sizes"])
    for i, (s, f) in enumerate(zip(gp["upsample_scales"], stages)):
        x = f(F.leaky_relu(f.up(x), slope))
        pre = f"upsamples.{i}.1"
        x = f.conv(F.conv_transpose1d, x, weight(w, pre), w[f"{pre}.bias"],
                   stride=s, padding=s // 2 + s % 2, output_padding=s % 2)
        total = None
        for j, (rk, dil) in enumerate(zip(gp["resblock_kernel_sizes"],
                                          gp["resblock_dilations"])):
            y = x
            for d_i, d in enumerate(dil):
                pre = f"blocks.{i * n_blocks + j}"
                h = conv(f, f(F.leaky_relu(f.up(y), slope)),
                         f"{pre}.convs1.{d_i}.1",
                         padding=(rk - 1) // 2 * d, dilation=d)
                y = f(y + conv(f, f(F.leaky_relu(f.up(h), slope)),
                               f"{pre}.convs2.{d_i}.1",
                               padding=(rk - 1) // 2))
            total = y if total is None else f(total + y)
        x = f(total / n_blocks)
    x = conv(head, head(F.leaky_relu(head.up(x), 0.01)), "output_conv.1",
             padding=(k - 1) // 2)
    return torch.tanh(x).to(out_dt)[:, 0]
