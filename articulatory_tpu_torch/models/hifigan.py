"""HiFi-GAN generator and discriminators (port of
``articulatory_tpu/models/hifigan.py``).

Input conv -> per stage (LeakyReLU, ConvTranspose1d upsample, MRF of
residual blocks) -> LeakyReLU(0.01) -> output conv -> tanh, over NLC
``(B, T, C)``. Kept exactly as the JAX package has them:

- the MRF blocks' outputs are *averaged*, not summed;
- the output LeakyReLU has torch's default slope 0.01;
- with ``use_ar`` the ``PastFCEncoder`` vector is tiled over time and
  concatenated to the input features (``in_channels`` includes it);
- ``compute_dtype`` runs the conv stack in that dtype; with
  ``hybrid_precision`` only the interior stages do, while the input conv, the
  last stage and the output conv (the path that feeds the AR carry) stay f32.
  The AR encoder always runs f32 and the output is always f32.

Conditioning, as in the JAX package:

- ``use_spk_id``: ``spk_emb_mat`` (``num_spk`` x ``spk_emb_size``) then
  ``spk_fc`` (to ``in_channels``, the width after the AR concat), added to
  the features at every frame;
- ``use_ph``: ``ph_emb_mat`` (``num_ph`` x ``ph_emb_size``) of the frame's
  phoneme id, concatenated to the features (the input conv takes
  ``in_channels + ph_emb_size``);
- ``use_ph_loss``: a phoneme head, ``ph_fc`` on the last stage's
  activation, average-pooled back to the frame rate (kernel 2 x
  prod(scales), stride prod(scales), padding prod(scales) / 2, padding
  counted); the forward then returns ``(wave, ph_logits)``.

The conditioning (embeddings, ``spk_fc``, ``ph_fc``) runs in f32 whatever
``compute_dtype`` is, as JAX's f32 parameters make it run there.

Module names follow the reference's state-dict keys: ``input_conv``,
``upsamples.{i}.1``, ``blocks.{i*n+j}``, ``output_conv.1``, ``ar_model``,
``spk_emb_mat``, ``spk_fc``, ``ph_emb_mat``, ``ph_fc``. ``run_stages(c,
start, stop)`` runs a range of the pipeline stages (``parallel/pp.py``);
a generator split by ``parallel/tp.py`` runs its rank's part of each.
``time_packing``,
``final_scale`` and ``extra_art`` are accepted and ignored.

The discriminators return lists of feature maps, each cast back to f32 when
``compute_dtype`` is bf16 (the last entry of each list is the logits):

- ``HiFiGANPeriodDiscriminator``: reflect-pad time to a multiple of the
  period, view as ``(B, T/P, P, C)`` and run a Conv2d stack (weight norm,
  or with ``use_spectral_norm`` the stateless spectral norm);
  its keys are ``convs.{i}.0`` and ``output_conv``;
- ``HiFiGANScaleDiscriminator``: a grouped Conv1d stack with no weight or
  spectral norm (the reference's norm is a no-op there); keys
  ``layers.{i}.0`` and, for the last, ``layers.{n-1}``. Layers 0-1 run as
  one ``ops/scale_disc_head`` call (the CUDA kernel on a card) whenever
  their shape is the head's: 1 input channel, kernels (15, 41), 128
  channels, LeakyReLU. That holds for every config in the repo; other
  shapes run the plain Conv1d layers;
- ``HiFiGANMultiScaleDiscriminator`` (AvgPool1d between scales, whatever
  ``downsample_pooling`` names, as the JAX package),
  ``HiFiGANMultiPeriodDiscriminator`` and
  ``HiFiGANMultiScaleMultiPeriodDiscriminator`` (keys ``msd.``/``mpd.``).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from articulatory_tpu_torch.layers.activations import get_activation
from articulatory_tpu_torch.layers.conv import (
    Conv1d,
    Conv2d,
    ConvTranspose1d,
    Dense,
    Embed,
)
from articulatory_tpu_torch.layers.past_encoder import PastFCEncoder
from articulatory_tpu_torch.layers.residual import HiFiGANResidualBlock
from articulatory_tpu_torch.ops.conv import avg_pool1d, leaky_relu
from articulatory_tpu_torch.ops.scale_disc_head import scale_disc_head
from articulatory_tpu_torch.parallel import tp as tp_ops


class HiFiGANGenerator(nn.Module):
    """Input ``c``: (B, T, in_channels - ar_output if use_ar else in_channels);
    ``ar``: (B, ar_input, 1); ``spk_id`` (B,) and ``ph`` (B, T) integer ids.
    Output: (B, T * prod(upsample_scales), out_channels), float32; with
    ``use_ph_loss`` also the phoneme logits (B, T, num_ph)."""

    def __init__(self, in_channels: int = 80, out_channels: int = 1,
                 channels: int = 512, kernel_size: int = 7,
                 upsample_scales: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 paddings: Sequence[Any] | None = None,
                 output_paddings: Sequence[Any] | None = None,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 use_additional_convs: bool = True, bias: bool = True,
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: dict | None = None,
                 use_weight_norm: bool = True, use_ar: bool = False,
                 ar_input: int = 512, ar_hidden: int = 256, ar_output: int = 128,
                 use_tanh: bool = True, use_spk_id: bool = False,
                 num_spk: int | None = None, spk_emb_size: int = 32,
                 use_ph: bool = False, num_ph: int | None = None,
                 ph_emb_size: int = 8, use_ph_loss: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 hybrid_precision: bool = False,
                 time_packing: Any = None, final_scale: Any = None,
                 extra_art: Any = None, seed: int = 0):
        super().__init__()
        del time_packing, final_scale, extra_art
        if use_spk_id and num_spk is None:
            raise ValueError("use_spk_id needs num_spk")
        if (use_ph or use_ph_loss) and num_ph is None:
            raise ValueError("use_ph and use_ph_loss need num_ph")
        scale = int(np.prod(upsample_scales))
        if use_ph_loss and scale % 2:
            raise ValueError(f"use_ph_loss pools by prod(upsample_scales), "
                             f"which must be even, got {scale}")
        if kernel_size % 2 != 1:
            raise ValueError("Kernel size must be odd number.")
        if len(upsample_scales) != len(upsample_kernel_sizes):
            raise ValueError("upsample_scales and upsample_kernel_sizes differ "
                             "in length")
        if len(resblock_dilations) != len(resblock_kernel_sizes):
            raise ValueError("resblock_dilations and resblock_kernel_sizes "
                             "differ in length")
        for name, value in (("paddings", paddings),
                            ("output_paddings", output_paddings)):
            if value is not None and any(p != "default" for p in value):
                raise ValueError(f"only 'default' {name} are implemented")
        generator = torch.Generator().manual_seed(seed)
        act_params = nonlinear_activation_params or {"negative_slope": 0.1}
        self.act = get_activation(nonlinear_activation, act_params)
        self.use_ar = use_ar
        self.use_spk_id, self.use_ph = use_spk_id, use_ph
        self.ph_pool = scale if use_ph_loss else None
        self.use_tanh = use_tanh
        self.compute_dtype = compute_dtype
        self.hybrid_precision = hybrid_precision
        self.num_blocks = len(resblock_kernel_sizes)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.tp = None  # a parallel/tp.py Plan once split
        # with weight norm off the reference's post-norm N(0, 0.01) reset is
        # effective (under weight norm it is a no-op)
        kinit = "torch_default" if use_weight_norm else "normal:0.01"

        if use_ar:
            self.ar_model = PastFCEncoder(ar_input, ar_hidden, ar_output,
                                          generator=generator)
        self.input_conv = Conv1d(in_channels + (ph_emb_size if use_ph else 0),
                                 channels, kernel_size,
                                 padding=(kernel_size - 1) // 2,
                                 use_weight_norm=use_weight_norm,
                                 kernel_init=kinit, generator=generator)
        self.upsamples = nn.ModuleList()
        self.blocks = nn.ModuleList()
        for i, (scale, k) in enumerate(zip(upsample_scales,
                                           upsample_kernel_sizes)):
            ch = channels // (2 ** (i + 1))
            self.upsamples.append(nn.Sequential(
                nn.LeakyReLU(act_params.get("negative_slope", 0.01)),
                ConvTranspose1d(channels // (2 ** i), ch, k, stride=scale,
                                padding=scale // 2 + scale % 2,
                                output_padding=scale % 2,
                                use_weight_norm=use_weight_norm,
                                kernel_init=kinit, generator=generator)))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilations):
                self.blocks.append(HiFiGANResidualBlock(
                    kernel_size=rk, channels=ch, dilations=rd, bias=bias,
                    use_additional_convs=use_additional_convs,
                    nonlinear_activation=nonlinear_activation,
                    nonlinear_activation_params=act_params,
                    use_weight_norm=use_weight_norm, kernel_init=kinit,
                    generator=generator))
        self.output_conv = nn.Sequential(
            nn.LeakyReLU(),
            Conv1d(channels // (2 ** len(upsample_scales)), out_channels,
                   kernel_size, padding=(kernel_size - 1) // 2,
                   use_weight_norm=use_weight_norm, kernel_init=kinit,
                   generator=generator))
        # built last: the other modules draw the same initial weights with
        # the hooks on or off
        if use_spk_id:
            self.spk_emb_mat = Embed(num_spk, spk_emb_size, generator)
            self.spk_fc = Dense(spk_emb_size, in_channels, generator=generator)
        if use_ph:
            self.ph_emb_mat = Embed(num_ph, ph_emb_size, generator)
        if use_ph_loss:
            self.ph_fc = Dense(channels // (2 ** len(upsample_scales)), num_ph,
                               generator=generator)

    @property
    def num_pipeline_stages(self) -> int:
        """Stage 0 is the conditioning and the input conv, stages 1..U one
        upsample + MRF group each, stage U + 1 the output conv (and the
        phoneme head)."""
        return len(self.upsamples) + 2

    def forward(self, c: torch.Tensor, ar: torch.Tensor | None = None,
                spk_id: torch.Tensor | None = None,
                ph: torch.Tensor | None = None):
        return self.run_stages(c, 0, self.num_pipeline_stages, ar=ar,
                               spk_id=spk_id, ph=ph)

    def run_stages(self, c: torch.Tensor, start: int, stop: int,
                   ar: torch.Tensor | None = None,
                   spk_id: torch.Tensor | None = None,
                   ph: torch.Tensor | None = None):
        """Pipeline stages ``[start, stop)`` only (JAX's ``run_stages``):
        ``run_stages(c, 0, num_pipeline_stages)`` is the forward, and
        chaining contiguous ranges reproduces it bit for bit (a handoff is
        the raw activation between stages, its dtype kept). A generator
        split for tensor parallelism (``parallel/tp.py``, ``self.tp``)
        runs its rank's part of every stage."""
        n_stages = self.num_pipeline_stages
        if not 0 <= start < stop <= n_stages:
            raise ValueError(
                f"stage range [{start}, {stop}) is not a non-empty subrange "
                f"of [0, {n_stages})")
        tp = self.tp
        head_dt = None if self.hybrid_precision else self.compute_dtype
        if start == 0:
            if self.use_ar:
                ar_feats = self.ar_model(ar)  # (B, ar_output), f32
                c = torch.cat([c, ar_feats[:, None, :].expand(
                    c.shape[0], c.shape[1], ar_feats.shape[-1])], dim=-1)
            if self.use_spk_id:
                c = c + self.spk_fc(self.spk_emb_mat(spk_id))[:, None, :]
            if self.use_ph:
                c = torch.cat([c, self.ph_emb_mat(ph)], dim=-1)
            c = (self.input_conv(c, head_dt) if tp is None else
                 tp_ops.conv1d_split(self.input_conv, c, head_dt, tp))
        n_up = len(self.upsamples)
        for i, up in enumerate(self.upsamples):
            if not start <= i + 1 < stop:
                continue
            # hybrid precision: the final stage stays f32 (it feeds the AR
            # carry)
            stage_dt = (None if self.hybrid_precision and i == n_up - 1
                        else self.compute_dtype)
            if stage_dt is None and c.dtype == torch.bfloat16:
                c = c.float()
            nb = self.num_blocks
            if tp is not None:
                c = tp_ops.conv_transpose1d_split(up[1], self.act(c),
                                                  stage_dt, tp)
                c = tp_ops.mrf_split(self.blocks, c, i * nb, nb, stage_dt, tp)
                continue
            c = up[1](self.act(c), stage_dt)
            cs = 0.0
            for j in range(nb):
                cs = cs + self.blocks[i * nb + j](c, stage_dt)
            c = cs / nb
        if stop < n_stages:
            return c
        pre = leaky_relu(c, 0.01)
        out = (self.output_conv[1](pre, head_dt) if tp is None else
               tp_ops.conv1d_split(self.output_conv[1], pre, head_dt, tp))
        if self.use_tanh:
            out = torch.tanh(out)
        out = _f32(out)
        if self.ph_pool is None:
            return out
        s = self.ph_pool
        ph_out = avg_pool1d(self.ph_fc(_f32(c)), 2 * s, s, s // 2)
        return out, ph_out

    def remove_weight_norm(self) -> None:
        """Freeze every conv's kernel (computed once per dtype from then on)."""
        for m in self.modules():
            if isinstance(m, (Conv1d, ConvTranspose1d)):
                m.remove_weight_norm()


def _f32(x: torch.Tensor) -> torch.Tensor:
    """A feature map in at least f32 (the JAX package's
    ``promote_types(dtype, float32)``)."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def _generator(generator: torch.Generator | None, seed: int) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(seed)


class HiFiGANPeriodDiscriminator(nn.Module):
    """x ``(B, T, C)`` -> feature maps ``(B, H_i, P, C_i)`` and flattened
    logits ``(B, -1)``."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 period: int = 3, kernel_sizes: Sequence[int] = (5, 3),
                 channels: int = 32,
                 downsample_scales: Sequence[int] = (3, 3, 3, 3, 1),
                 max_downsample_channels: int = 1024, bias: bool = True,
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: dict | None = None,
                 use_weight_norm: bool = True, use_spectral_norm: bool = False,
                 compute_dtype: torch.dtype | None = None, seed: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        if len(kernel_sizes) != 2 or any(k % 2 != 1 for k in kernel_sizes):
            raise ValueError("kernel_sizes must be two odd sizes")
        if use_weight_norm and use_spectral_norm:
            raise ValueError("Either use use_weight_norm or use_spectral_norm.")
        generator = _generator(generator, seed)
        self.period = period
        self.compute_dtype = compute_dtype
        self.act = get_activation(nonlinear_activation,
                                  nonlinear_activation_params
                                  or {"negative_slope": 0.1})
        norms = dict(use_weight_norm=use_weight_norm,
                     use_spectral_norm=use_spectral_norm, generator=generator)
        k0, k1 = kernel_sizes
        self.convs = nn.ModuleList()
        in_chs, out_chs = in_channels, channels
        for scale in downsample_scales:
            self.convs.append(nn.Sequential(
                Conv2d(in_chs, out_chs, (k0, 1), stride=(scale, 1),
                       padding=((k0 - 1) // 2, 0), bias=bias, **norms),
                nn.LeakyReLU()))
            in_chs = out_chs
            out_chs = min(out_chs * 4, max_downsample_channels)
        self.output_conv = Conv2d(in_chs, out_channels, (k1 - 1, 1),
                                  padding=((k1 - 1) // 2, 0), **norms)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        b, t, c = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x.transpose(1, 2), (0, n_pad), mode="reflect"
                      ).transpose(1, 2)
            t += n_pad
        dtype = self.compute_dtype or x.dtype
        x = x.reshape(b, t // self.period, self.period, c).to(dtype)
        outs = []
        for conv in self.convs:
            x = self.act(conv[0](x, dtype))
            outs.append(_f32(x))
        x = self.output_conv(x, dtype)
        outs.append(_f32(x.reshape(b, -1)))
        return outs


class HiFiGANMultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 discriminator_params: dict | None = None,
                 compute_dtype: torch.dtype | None = None, seed: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        generator = _generator(generator, seed)
        params = dict(discriminator_params or {})
        params.setdefault("compute_dtype", compute_dtype)
        self.discriminators = nn.ModuleList([
            HiFiGANPeriodDiscriminator(**dict(params, period=p),
                                       generator=generator)
            for p in periods])

    def forward(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        return [d(x) for d in self.discriminators]


class HiFiGANScaleDiscriminator(nn.Module):
    """x ``(B, T, C)`` -> feature maps ``(B, T_i, C_i)``, the last the
    logits ``(B, T_n, out_channels)``."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 kernel_sizes: Sequence[int] = (15, 41, 5, 3),
                 channels: int = 128, max_downsample_channels: int = 1024,
                 max_groups: int = 16, bias: bool = True,
                 downsample_scales: Sequence[int] = (2, 2, 4, 4, 1),
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: dict | None = None,
                 use_weight_norm: bool = True, use_spectral_norm: bool = False,
                 compute_dtype: torch.dtype | None = None, seed: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        del use_weight_norm, use_spectral_norm  # no-ops here, as in JAX
        if len(kernel_sizes) != 4 or any(k % 2 != 1 for k in kernel_sizes):
            raise ValueError("kernel_sizes must be four odd sizes")
        generator = _generator(generator, seed)
        act_params = nonlinear_activation_params or {"negative_slope": 0.1}
        self.act = get_activation(nonlinear_activation, act_params)
        self.compute_dtype = compute_dtype
        self.downsample_scales = tuple(downsample_scales)
        k0, k1, k2, k3 = kernel_sizes

        def layer(c_in, c_out, k, stride=1, groups=1, last=False):
            conv = Conv1d(c_in, c_out, k, stride=stride,
                          padding=(k - 1) // 2, groups=groups, bias=bias,
                          generator=generator)
            return conv if last else nn.Sequential(conv, nn.LeakyReLU())

        layers = [layer(in_channels, channels, k0)]
        in_chs = out_chs = channels
        groups = 4
        for scale in downsample_scales:
            layers.append(layer(in_chs, out_chs, k1, stride=scale,
                                groups=groups))
            in_chs = out_chs
            out_chs = min(in_chs * 2, max_downsample_channels)
            groups = min(groups * 4, max_groups)
        out_chs = min(in_chs * 2, max_downsample_channels)
        layers.append(layer(in_chs, out_chs, k2))
        layers.append(layer(out_chs, out_channels, k3, last=True))
        self.layers = nn.ModuleList(layers)
        # layers 0-1 in the head's shape go through the fused head
        self.head_slope = (act_params.get("negative_slope", 0.01)
                           if nonlinear_activation == "LeakyReLU" else None)
        self.use_head = (in_channels == 1 and (k0, k1) == (15, 41)
                         and channels == 128 and len(downsample_scales) > 0
                         and self.head_slope is not None)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        dtype = self.compute_dtype or x.dtype
        x = x.to(dtype)
        outs = []
        body = self.layers[:-1]
        if self.use_head:
            w0, b0 = self.layers[0][0].kernel(dtype)
            wg, b1 = self.layers[1][0].kernel(dtype)
            h0, x = scale_disc_head(x.contiguous(), w0, b0, wg, b1,
                                    stride=self.downsample_scales[0],
                                    negative_slope=self.head_slope)
            outs += [_f32(h0), _f32(x)]
            body = body[2:]
        for layer in body:
            x = self.act(layer[0](x, dtype))
            outs.append(_f32(x))
        outs.append(_f32(self.layers[-1](x, dtype)))
        return outs


class HiFiGANMultiScaleDiscriminator(nn.Module):
    def __init__(self, scales: int = 3, downsample_pooling: str = "AvgPool1d",
                 downsample_pooling_params: dict | None = None,
                 discriminator_params: dict | None = None,
                 follow_official_norm: bool = False,
                 compute_dtype: torch.dtype | None = None, seed: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        # follow_official_norm toggles norms that are no-ops in the scale
        # stack; the pooling is AvgPool1d whatever its name, as in JAX
        del downsample_pooling, follow_official_norm
        generator = _generator(generator, seed)
        self.pool = downsample_pooling_params or {
            "kernel_size": 4, "stride": 2, "padding": 2}
        params = dict(discriminator_params or {})
        params.setdefault("compute_dtype", compute_dtype)
        self.discriminators = nn.ModuleList([
            HiFiGANScaleDiscriminator(**params, generator=generator)
            for _ in range(scales)])

    def forward(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        outs = []
        for d in self.discriminators:
            outs.append(d(x))
            x = avg_pool1d(x, self.pool["kernel_size"], self.pool["stride"],
                           self.pool["padding"])
        return outs


class HiFiGANMultiScaleMultiPeriodDiscriminator(nn.Module):
    """MSD outputs then MPD outputs, one list of feature maps per
    sub-discriminator."""

    def __init__(self, scales: int = 3,
                 scale_downsample_pooling: str = "AvgPool1d",
                 scale_downsample_pooling_params: dict | None = None,
                 scale_discriminator_params: dict | None = None,
                 follow_official_norm: bool = True,
                 periods: Sequence[int] = (2, 3, 5, 7, 11),
                 period_discriminator_params: dict | None = None,
                 compute_dtype: torch.dtype | None = None, seed: int = 0):
        super().__init__()
        generator = torch.Generator().manual_seed(seed)
        self.msd = HiFiGANMultiScaleDiscriminator(
            scales=scales, downsample_pooling=scale_downsample_pooling,
            downsample_pooling_params=scale_downsample_pooling_params,
            discriminator_params=scale_discriminator_params,
            follow_official_norm=follow_official_norm,
            compute_dtype=compute_dtype, generator=generator)
        self.mpd = HiFiGANMultiPeriodDiscriminator(
            periods=periods, discriminator_params=period_discriminator_params,
            compute_dtype=compute_dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        return self.msd(x) + self.mpd(x)
