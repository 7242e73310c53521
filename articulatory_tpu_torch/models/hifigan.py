"""HiFi-GAN generator (port of ``articulatory_tpu/models/hifigan.py``).

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

Module names follow the reference's state-dict keys: ``input_conv``,
``upsamples.{i}.1``, ``blocks.{i*n+j}``, ``output_conv.1``, ``ar_model``.
``time_packing``, ``final_scale`` and ``extra_art`` are accepted and ignored.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from articulatory_tpu_torch.layers.activations import get_activation
from articulatory_tpu_torch.layers.conv import Conv1d, ConvTranspose1d
from articulatory_tpu_torch.layers.past_encoder import PastFCEncoder
from articulatory_tpu_torch.layers.residual import HiFiGANResidualBlock
from articulatory_tpu_torch.ops.conv import leaky_relu


class HiFiGANGenerator(nn.Module):
    """Input ``c``: (B, T, in_channels - ar_output if use_ar else in_channels);
    ``ar``: (B, ar_input, 1). Output: (B, T * prod(upsample_scales),
    out_channels), float32."""

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
        del time_packing, final_scale, extra_art, spk_emb_size, num_spk
        del num_ph, ph_emb_size
        if use_spk_id or use_ph or use_ph_loss:
            raise NotImplementedError(
                "use_spk_id / use_ph / use_ph_loss are not ported yet")
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
        self.use_tanh = use_tanh
        self.compute_dtype = compute_dtype
        self.hybrid_precision = hybrid_precision
        self.num_blocks = len(resblock_kernel_sizes)
        # with weight norm off the reference's post-norm N(0, 0.01) reset is
        # effective (under weight norm it is a no-op)
        kinit = "torch_default" if use_weight_norm else "normal:0.01"

        if use_ar:
            self.ar_model = PastFCEncoder(ar_input, ar_hidden, ar_output,
                                          generator=generator)
        self.input_conv = Conv1d(in_channels, channels, kernel_size,
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

    def forward(self, c: torch.Tensor, ar: torch.Tensor | None = None
                ) -> torch.Tensor:
        if self.use_ar:
            ar_feats = self.ar_model(ar)  # (B, ar_output), f32
            c = torch.cat([c, ar_feats[:, None, :].expand(
                c.shape[0], c.shape[1], ar_feats.shape[-1])], dim=-1)
        head_dt = None if self.hybrid_precision else self.compute_dtype
        c = self.input_conv(c, head_dt)
        n_up = len(self.upsamples)
        for i, up in enumerate(self.upsamples):
            # hybrid precision: the final stage stays f32 (it feeds the AR
            # carry)
            stage_dt = (None if self.hybrid_precision and i == n_up - 1
                        else self.compute_dtype)
            if stage_dt is None and c.dtype == torch.bfloat16:
                c = c.float()
            c = up[1](self.act(c), stage_dt)
            cs = 0.0
            for j in range(self.num_blocks):
                cs = cs + self.blocks[i * self.num_blocks + j](c, stage_dt)
            c = cs / self.num_blocks
        out = self.output_conv[1](leaky_relu(c, 0.01), head_dt)
        if self.use_tanh:
            out = torch.tanh(out)
        return out.float() if out.dtype != torch.float64 else out

    def remove_weight_norm(self) -> None:
        """Freeze every conv's kernel (computed once per dtype from then on)."""
        for m in self.modules():
            if isinstance(m, (Conv1d, ConvTranspose1d)):
                m.remove_weight_norm()
