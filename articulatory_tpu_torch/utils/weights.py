"""Weights carried across from the JAX package's parameter trees.

``jax_params_to_state_dict`` turns the JAX ``HiFiGANGenerator`` param tree
(nested dicts of numpy arrays) into the port's ``state_dict`` (and a
``PastSeqEncoder``'s tree with its ``batch_stats``), and
``jax_msmpd_to_state_dict`` the JAX
``HiFiGANMultiScaleMultiPeriodDiscriminator`` tree, and
``jax_bigru_to_state_dict`` the JAX ``BiGRU`` tree with its BatchNorm
``batch_stats``; all have the reference's torch keys and layouts:

- Conv1d (K, C_in, C_out) -> (C_out, C_in, K);
- Conv2d (Kh, Kw, C_in, C_out) -> (C_out, C_in, Kh, Kw);
- ConvTranspose1d (K, C_in, C_out), time-flipped -> (C_in, C_out, K),
  un-flipped;
- Dense (in, out) -> (out, in); an embedding table as it is (the
  conditioning's ``spk_emb_mat`` and ``ph_emb_mat``);
- GRU ``w_ih``, ``w_hh``, ``b_ih``, ``b_hh`` (torch's packing already) ->
  ``weight_ih_l0`` ... , ``_reverse`` for the backward direction;
- BatchNorm scale, bias and the running mean and variance -> ``weight``,
  ``bias``, ``running_mean``, ``running_var``;
- weight-norm (g, v) -> ``weight_g`` / ``weight_v`` on torch's axes.

The zoo's converters (``jax_melgan_generator_to_state_dict`` ...,
dispatched by class name through ``generator_to_state_dict`` and
``discriminator_to_state_dict``) give the keys of the JAX package's
``utils/torch_export.py`` exporters: a PWG ``UpsampleNetwork`` Conv2d, an
effective weight in JAX, becomes ``weight_v = w``, ``weight_g = ||w||``
(``_unfold_conv2d_wn``); a ``Transformer``'s relative table gains the
reference's trailing axis of 1; BatchNorm statistics come from the
mutables, ``num_batches_tracked`` from the step count. A cascade's
``generator2`` tree goes through the same converters under its own
``generator2_type`` (``utils/checkpoint.py::generator_state_dict``).

The inverse, a reference (or port) state dict -> the JAX param tree, is
``GENERATOR_TO_JAX`` (type -> ``(params, mutables)``, BatchNorm statistics
as ``{"batch_stats": ...}``) and ``DISCRIMINATOR_TO_JAX`` (type -> params),
the JAX package's ``utils/torch_import.py`` importers for the same families
(HiFi-GAN with AR, speaker, phoneme and multi-band forms; MelGAN; PWG;
StyleMelGAN; GBlock; BiGRU; Transformer; and the MSMPD, MelGAN MSD,
StyleMelGAN and PWG discriminators), computed with the same numpy
operations: a PWG upsampling Conv2d is folded to its effective weight. A
missing key raises ``KeyError``.

``fold_weight_norm`` is ``remove_weight_norm`` on a state dict: each
``weight_v`` becomes the effective weight and ``weight_g`` its norm, so the
forward computes the same kernel from an exactly normalised v.

``split_tp_state_dict`` gives a rank of a tensor-parallel group its part of
a full HiFi-GAN generator state dict (``parallel/tp.py``'s layout:
``tp_key_spec``), and ``gather_tp_state_dicts`` puts the ranks' parts back
together into the full state dict.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    # a copy with canonical strides: ascontiguousarray keeps a negative
    # stride on an axis of size 1 (a flipped kernel of one tap)
    return torch.tensor(np.asarray(a).copy())


def _conv1d(sd: dict, prefix: str, p: Mapping[str, Any]) -> None:
    if "v" in p:
        sd[f"{prefix}.weight_v"] = _tensor(np.transpose(p["v"], (2, 1, 0)))
        sd[f"{prefix}.weight_g"] = _tensor(np.transpose(p["g"], (2, 1, 0)))
    else:
        sd[f"{prefix}.weight"] = _tensor(np.transpose(p["w"], (2, 1, 0)))
    if "b" in p:
        sd[f"{prefix}.bias"] = _tensor(p["b"])


def _conv_transpose1d(sd: dict, prefix: str, p: Mapping[str, Any]) -> None:
    if "v" in p:
        sd[f"{prefix}.weight_v"] = _tensor(
            np.transpose(p["v"], (1, 2, 0))[:, :, ::-1])
        sd[f"{prefix}.weight_g"] = _tensor(np.transpose(p["g"], (1, 2, 0)))
    else:
        sd[f"{prefix}.weight"] = _tensor(
            np.transpose(p["w"], (1, 2, 0))[:, :, ::-1])
    if "b" in p:
        sd[f"{prefix}.bias"] = _tensor(p["b"])


def _conv2d(sd: dict, prefix: str, p: Mapping[str, Any]) -> None:
    for src, dst in (("v", "weight_v"), ("g", "weight_g"), ("w", "weight")):
        if src in p:
            sd[f"{prefix}.{dst}"] = _tensor(np.transpose(p[src], (3, 2, 0, 1)))
    if "b" in p:
        sd[f"{prefix}.bias"] = _tensor(p["b"])


def _linear(sd: dict, prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _tensor(np.transpose(p["w"], (1, 0)))
    if "b" in p:
        sd[f"{prefix}.bias"] = _tensor(p["b"])


def _batch_norm(sd: dict, prefix: str, p: Mapping[str, Any],
                stats: Mapping[str, Any], steps: int = 0) -> None:
    sd[f"{prefix}.weight"] = _tensor(p["scale"])
    sd[f"{prefix}.bias"] = _tensor(p["bias"])
    sd[f"{prefix}.running_mean"] = _tensor(stats["mean"])
    sd[f"{prefix}.running_var"] = _tensor(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(steps,
                                                       dtype=torch.long)


def _ar_model(sd: dict, params: Mapping[str, Any]) -> None:
    for li, ti in enumerate([0, 2, 4, 6, 8]):
        _linear(sd, f"ar_model.model.{ti}", params["ar_model"][f"fc{li}"])


def _embedding(sd: dict, prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _tensor(p["w"])


def _speaker(sd: dict, params: Mapping[str, Any],
             generator_params: Mapping[str, Any]) -> None:
    """``spk_emb_mat`` and ``spk_fc`` of a ``use_spk_id`` generator."""
    if generator_params.get("use_spk_id", False):
        _embedding(sd, "spk_emb_mat", params["spk_emb_mat"])
        _linear(sd, "spk_fc", params["spk_fc"])


def _res_block(sd: dict, prefix: str, p: Mapping[str, Any],
               stats: Mapping[str, Any], steps: int) -> None:
    """A conv-BatchNorm ``ResBlock`` and its statistics."""
    _conv1d(sd, f"{prefix}.conv1", p["conv1"])
    _conv1d(sd, f"{prefix}.conv2", p["conv2"])
    for bn in ("bn1", "bn2"):
        _batch_norm(sd, f"{prefix}.{bn}", p[bn], stats[bn], steps)
    if "residual_path" in p:
        _conv1d(sd, f"{prefix}.residual_path", p["residual_path"])
        _batch_norm(sd, f"{prefix}.res_norm", p["res_norm"],
                    stats["res_norm"], steps)


def _encoder_layer(sd: dict, prefix: str, layer: Mapping[str, Any]) -> None:
    """A ``TransformerEncoderLayer``: the relative table gains the
    reference's trailing axis of 1."""
    attn = layer["self_attn"]
    for k in ("w_q", "w_k", "w_v", "w_o"):
        sd[f"{prefix}.self_attn.{k}"] = _tensor(attn[k])
    sd[f"{prefix}.self_attn.relative_positional.embeddings"] = _tensor(
        np.asarray(attn["rel_embeddings"])[..., None])
    _linear(sd, f"{prefix}.linear1", layer["linear1"])
    _linear(sd, f"{prefix}.linear2", layer["linear2"])
    for norm in ("norm1", "norm2"):
        sd[f"{prefix}.{norm}.weight"] = _tensor(layer[norm]["scale"])
        sd[f"{prefix}.{norm}.bias"] = _tensor(layer[norm]["bias"])


def jax_params_to_state_dict(params: Mapping[str, Any],
                             generator_params: Mapping[str, Any] | None = None,
                             mutables: Mapping[str, Any] | None = None,
                             steps: int = 0) -> dict[str, torch.Tensor]:
    """JAX ``HiFiGANGenerator`` params -> the port's state dict (the keys
    of the JAX package's ``export_hifigan_generator``, the conditioning
    leaves included); or a ``PastSeqEncoder``'s (its ``res0`` and
    ``layer{i}`` trees, the ``res0`` statistics from ``mutables``' or its
    ``batch_stats``)."""
    sd: dict[str, torch.Tensor] = {}
    if "res0" in params and "input_conv" not in params:
        stats = (mutables or {}).get("batch_stats", mutables or {})
        _res_block(sd, "res0", params["res0"], stats["res0"], steps)
        for i in range(sum(k.startswith("layer") for k in params)):
            _encoder_layer(sd, f"transformer.layers.{i}", params[f"layer{i}"])
        return sd
    generator_params = generator_params or {}
    num_ups = len(generator_params.get("upsample_scales", (8, 8, 2, 2)))
    rks = generator_params.get("resblock_kernel_sizes", (3, 7, 11))
    rdils = generator_params.get("resblock_dilations", ((1, 3, 5),) * 3)
    use_additional = generator_params.get("use_additional_convs", True)

    _conv1d(sd, "input_conv", params["input_conv"])
    for i in range(num_ups):
        _conv_transpose1d(sd, f"upsamples.{i}.1", params[f"upsample_{i}"])
        for j in range(len(rks)):
            block = params[f"block_{i}_{j}"]
            idx = i * len(rks) + j
            for d in range(len(rdils[j])):
                _conv1d(sd, f"blocks.{idx}.convs1.{d}.1", block[f"convs1_{d}"])
                if use_additional:
                    _conv1d(sd, f"blocks.{idx}.convs2.{d}.1",
                            block[f"convs2_{d}"])
    _conv1d(sd, "output_conv.1", params["output_conv"])
    if generator_params.get("use_ar", False):
        _ar_model(sd, params)
    _speaker(sd, params, generator_params)
    if generator_params.get("use_ph", False):
        _embedding(sd, "ph_emb_mat", params["ph_emb_mat"])
    if generator_params.get("use_ph_loss", False):
        _linear(sd, "ph_fc", params["ph_fc"])
    return sd


def jax_bigru_to_state_dict(params: Mapping[str, Any],
                            mutables: Mapping[str, Any],
                            generator_params: Mapping[str, Any],
                            steps: int = 0) -> dict[str, torch.Tensor]:
    """JAX ``BiGRU`` params and mutables (``{"batch_stats": {"bn": {"mean",
    "var"}}}``) -> the port's state dict (the keys of the JAX package's
    ``utils/torch_export.py::export_bigru``; ``num_batches_tracked`` the
    step count)."""
    sd: dict[str, torch.Tensor] = {}
    for name in ("gru1", "gru2"):
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            layer = params[name][direction]
            for src, dst in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                             ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                sd[f"{name}.{dst}_l0{suffix}"] = _tensor(layer[src])
    _linear(sd, "fc1.0", params["fc1"])
    stats = mutables.get("batch_stats", mutables)["bn"]
    _batch_norm(sd, "bn", params["bn"], stats, steps)
    _linear(sd, "fc2.0" if generator_params.get("use_tanh", False) else "fc2",
            params["fc2"])
    if generator_params.get("use_ar", False):
        _ar_model(sd, params)
    if generator_params.get("use_spk_emb", False):
        _linear(sd, "spk_fc", params["spk_fc"])
    return sd


def jax_msmpd_to_state_dict(params: Mapping[str, Any],
                            discriminator_params: Mapping[str, Any]
                            ) -> dict[str, torch.Tensor]:
    """JAX ``HiFiGANMultiScaleMultiPeriodDiscriminator`` params -> the
    port's state dict (the keys of the JAX package's
    ``utils/torch_export.py::export_hifigan_msmpd``). Scale discriminators
    carry plain weights; period discriminators weight norm."""
    sd: dict[str, torch.Tensor] = {}
    scale_params = discriminator_params.get("scale_discriminator_params", {})
    period_params = discriminator_params.get("period_discriminator_params", {})
    n_scale_layers = len(scale_params.get("downsample_scales",
                                          (2, 2, 4, 4, 1))) + 3
    n_period_convs = len(period_params.get("downsample_scales",
                                           (3, 3, 3, 3, 1)))
    for i in range(discriminator_params.get("scales", 3)):
        disc = params["msd"][f"disc_{i}"]
        for k in range(n_scale_layers):
            # Sequential(conv, act) but for the last layer, a bare conv
            last = k == n_scale_layers - 1
            _conv1d(sd, f"msd.discriminators.{i}.layers.{k}"
                    + ("" if last else ".0"), disc[f"layer_{k}"])
    for i in range(len(discriminator_params.get("periods", (2, 3, 5, 7, 11)))):
        disc = params["mpd"][f"disc_{i}"]
        for k in range(n_period_convs):
            _conv2d(sd, f"mpd.discriminators.{i}.convs.{k}.0", disc[f"conv_{k}"])
        _conv2d(sd, f"mpd.discriminators.{i}.output_conv", disc["output_conv"])
    return sd


def jax_melgan_generator_to_state_dict(params: Mapping[str, Any],
                                       generator_params: Mapping[str, Any]
                                       ) -> dict[str, torch.Tensor]:
    """JAX ``MelGANGenerator`` -> ``melgan.{i}`` keys (``export_melgan_
    generator``); a causal one (``use_causal_conv``, whose JAX layers nest
    ``conv`` / ``deconv``) -> the reference's causal layout, ``melgan.0.conv``,
    ``melgan.{i}.deconv``, ``melgan.{i}.stack.1.conv``, ``stack.3``."""
    sd: dict[str, torch.Tensor] = {}
    scales = generator_params.get("upsample_scales", (8, 8, 2, 2))
    stacks = generator_params.get("stacks", 3)
    causal = generator_params.get("use_causal_conv", False)
    # the reference's causal Sequential has no pad layers
    idx = 0 if causal else 1
    if causal:
        _conv1d(sd, "melgan.0.conv", params["first_conv"]["conv"])
    else:
        _conv1d(sd, "melgan.1", params["first_conv"])
    idx += 1
    for i in range(len(scales)):
        idx += 1  # the activation
        if causal:
            _conv_transpose1d(sd, f"melgan.{idx}.deconv",
                              params[f"upsample_{i}"]["deconv"])
        else:
            _conv_transpose1d(sd, f"melgan.{idx}", params[f"upsample_{i}"])
        idx += 1
        for j in range(stacks):
            stack = params[f"stack_{i}_{j}"]
            if causal:
                _conv1d(sd, f"melgan.{idx}.stack.1.conv",
                        stack["conv_dilated"]["conv"])
                _conv1d(sd, f"melgan.{idx}.stack.3", stack["conv_out"])
            else:
                _conv1d(sd, f"melgan.{idx}.stack.2", stack["conv_dilated"])
                _conv1d(sd, f"melgan.{idx}.stack.4", stack["conv_out"])
            _conv1d(sd, f"melgan.{idx}.skip_layer", stack["conv_skip"])
            idx += 1
    if causal:
        _conv1d(sd, f"melgan.{idx + 1}.conv", params["last_conv"]["conv"])
    else:
        _conv1d(sd, f"melgan.{idx + 2}", params["last_conv"])
    return sd


def _wavenet_layers(sd: dict, params: Mapping[str, Any], layers: int,
                    aux: bool) -> None:
    for i in range(layers):
        layer = params[f"conv_layer_{i}"]
        names = ("conv", "conv1x1_aux", "conv1x1_skip", "conv1x1_out")
        for name in names if aux else names[:1] + names[2:]:
            _conv1d(sd, f"conv_layers.{i}.{name}", layer[name])
    _conv1d(sd, "last_conv_layers.1", params["last_conv_0"])
    _conv1d(sd, "last_conv_layers.3", params["last_conv_1"])


def jax_pwg_generator_to_state_dict(params: Mapping[str, Any],
                                    generator_params: Mapping[str, Any]
                                    ) -> dict[str, torch.Tensor]:
    """JAX ``ParallelWaveGANGenerator`` -> the reference's keys
    (``export_pwg_generator``); a causal one has the same keys (its
    ``conv_in`` is ``aux_context_window + 1`` wide)."""
    sd: dict[str, torch.Tensor] = {}
    up = generator_params.get("upsample_params",
                              {"upsample_scales": [4, 4, 4, 4]})
    stride = 2 if up.get("nonlinear_activation") is None else 3
    _conv1d(sd, "first_conv", params["first_conv"])
    if generator_params.get("upsample_conditional_features", True):
        net = params["upsample_net"]
        ups = net["upsample"] if "upsample" in net else net
        for i in range(len(up.get("upsample_scales", [4, 4, 4, 4]))):
            # JAX keeps the effective weight: v = w, g = ||w||
            w = np.transpose(np.asarray(ups[f"conv_{i}_w"]), (3, 2, 0, 1))
            prefix = "upsample_net" + (".upsample" if "conv_in" in net
                                       else "")
            prefix += f".up_layers.{1 + i * stride}"
            sd[f"{prefix}.weight_v"] = _tensor(w)
            sd[f"{prefix}.weight_g"] = _tensor(np.sqrt(
                (w ** 2).sum(axis=(1, 2, 3), keepdims=True)))
        if "conv_in" in net:
            _conv1d(sd, "upsample_net.conv_in", net["conv_in"])
    _wavenet_layers(sd, params, generator_params.get("layers", 30), True)
    return sd


def jax_style_melgan_generator_to_state_dict(
        params: Mapping[str, Any], generator_params: Mapping[str, Any]
        ) -> dict[str, torch.Tensor]:
    """JAX ``StyleMelGANGenerator`` -> the reference's keys
    (``export_style_melgan_generator``)."""
    sd: dict[str, torch.Tensor] = {}
    noise_scales = generator_params.get("noise_upsample_scales",
                                        (11, 2, 2, 2))
    up_scales = generator_params.get("upsample_scales",
                                     (2, 2, 2, 2, 2, 2, 2, 2, 1))
    for i in range(len(noise_scales)):
        _conv_transpose1d(sd, f"noise_upsample.{2 * i}",
                          params[f"noise_upsample_{i}"])
    for i in range(len(up_scales)):
        blk = params[f"block_{i}"]
        for tade in ("tade1", "tade2"):
            for conv in ("aux_conv", "gated_conv"):
                _conv1d(sd, f"blocks.{i}.{tade}.{conv}.0", blk[tade][conv])
        _conv1d(sd, f"blocks.{i}.gated_conv1", blk["gated_conv1"])
        _conv1d(sd, f"blocks.{i}.gated_conv2", blk["gated_conv2"])
    _conv1d(sd, "output_conv.0", params["output_conv"])
    return sd


def jax_gblock_generator_to_state_dict(params: Mapping[str, Any],
                                       generator_params: Mapping[str, Any]
                                       ) -> dict[str, torch.Tensor]:
    """JAX ``GBlockGenerator`` -> the reference's keys
    (``export_gblock_generator``)."""
    sd: dict[str, torch.Tensor] = {}
    _conv1d(sd, "input_conv", params["input_conv"])
    for i, scale in enumerate(generator_params.get("g_scales", (8, 8, 2, 2))):
        off = 1 if scale > 1 else 0  # the Upsample layer shifts the keys
        blk, r = params[f"resample_{i}"], f"resamples.{i}"
        _conv1d(sd, f"{r}.conv1.{1 + off}", blk["conv1_a"])
        _conv1d(sd, f"{r}.conv1.{3 + off}", blk["conv1_b"])
        _conv1d(sd, f"{r}.res1.{off}", blk["res1"])
        _conv1d(sd, f"{r}.conv2.1", blk["conv2_a"])
        _conv1d(sd, f"{r}.conv2.3", blk["conv2_b"])
    _conv1d(sd, "output_conv.1", params["output_conv"])
    if generator_params.get("use_ar", False):
        _ar_model(sd, params)
    _speaker(sd, params, generator_params)
    return sd


def jax_transformer_to_state_dict(params: Mapping[str, Any],
                                  mutables: Mapping[str, Any],
                                  generator_params: Mapping[str, Any],
                                  steps: int = 0
                                  ) -> dict[str, torch.Tensor]:
    """JAX ``Transformer`` params and ``batch_stats`` -> the reference's
    keys (``export_transformer``)."""
    sd: dict[str, torch.Tensor] = {}
    stats = mutables.get("batch_stats", mutables)
    base = 0
    if generator_params.get("extra_art", False):
        _conv1d(sd, "conv_blocks.0", params["front_conv"])
        base = 1
    for i in range(3):
        _res_block(sd, f"conv_blocks.{base + i}", params[f"res{i}"],
                   stats[f"res{i}"], steps)
    _linear(sd, "w_raw_in", params["w_raw_in"])
    for i in range(generator_params.get("elayers", 6)):
        _encoder_layer(sd, f"transformer.layers.{i}", params[f"layer{i}"])
    if "in_emb_mat" in params:
        _embedding(sd, "in_emb_mat", params["in_emb_mat"])
    _linear(sd, "w_out", params["w_out"])
    return sd


def _melgan_discriminator(sd: dict, prefix: str, disc: Mapping[str, Any],
                          discriminator_params: Mapping[str, Any]) -> None:
    n_down = len(discriminator_params.get("downsample_scales", (4, 4, 4, 4)))
    _conv1d(sd, f"{prefix}layers.0.1", disc["layer_0"])
    for k in range(1, n_down + 2):
        _conv1d(sd, f"{prefix}layers.{k}.0", disc[f"layer_{k}"])
    _conv1d(sd, f"{prefix}layers.{n_down + 2}", disc[f"layer_{n_down + 2}"])


def jax_melgan_discriminator_to_state_dict(
        params: Mapping[str, Any], discriminator_params: Mapping[str, Any]
        ) -> dict[str, torch.Tensor]:
    """JAX ``MelGANDiscriminator`` -> ``layers.{i}`` keys."""
    sd: dict[str, torch.Tensor] = {}
    _melgan_discriminator(sd, "", params, discriminator_params)
    return sd


def jax_melgan_msd_to_state_dict(params: Mapping[str, Any],
                                 discriminator_params: Mapping[str, Any]
                                 ) -> dict[str, torch.Tensor]:
    """JAX ``MelGANMultiScaleDiscriminator`` -> the reference's keys
    (``export_melgan_msd``)."""
    sd: dict[str, torch.Tensor] = {}
    for i in range(discriminator_params.get("scales", 3)):
        _melgan_discriminator(sd, f"discriminators.{i}.", params[f"disc_{i}"],
                              discriminator_params)
    return sd


def jax_style_melgan_discriminator_to_state_dict(
        params: Mapping[str, Any], discriminator_params: Mapping[str, Any]
        ) -> dict[str, torch.Tensor]:
    """JAX ``StyleMelGANDiscriminator`` -> the reference's keys
    (``export_style_melgan_discriminator``)."""
    sd: dict[str, torch.Tensor] = {}
    inner = discriminator_params.get("discriminator_params", {})
    n = len(discriminator_params.get("pqmf_params", ((1,),) * 4))
    for i in range(n):
        _melgan_discriminator(sd, f"discriminators.{i}.", params[f"disc_{i}"],
                              inner)
    return sd


def jax_pwg_discriminator_to_state_dict(
        params: Mapping[str, Any], discriminator_params: Mapping[str, Any]
        ) -> dict[str, torch.Tensor]:
    """JAX ``ParallelWaveGANDiscriminator`` -> ``conv_layers.{2 i}``
    (``export_pwg_discriminator``)."""
    sd: dict[str, torch.Tensor] = {}
    for i in range(discriminator_params.get("layers", 10)):
        _conv1d(sd, f"conv_layers.{2 * i}", params[f"conv_{i}"])
    return sd


def jax_residual_pwg_discriminator_to_state_dict(
        params: Mapping[str, Any], discriminator_params: Mapping[str, Any]
        ) -> dict[str, torch.Tensor]:
    """JAX ``ResidualParallelWaveGANDiscriminator`` -> the reference's keys
    (``first_conv.0``, ``conv_layers.{i}``, ``last_conv_layers.{1,3}``; the
    JAX package has no exporter for it)."""
    sd: dict[str, torch.Tensor] = {}
    _conv1d(sd, "first_conv.0", params["first_conv"])
    _wavenet_layers(sd, params, discriminator_params.get("layers", 30), False)
    return sd


def generator_to_state_dict(generator_type: str, params: Mapping[str, Any],
                            mutables: Mapping[str, Any],
                            generator_params: Mapping[str, Any],
                            steps: int = 0) -> dict[str, torch.Tensor]:
    """Any ported JAX generator's params (and mutables) -> the port's state
    dict."""
    plain = {
        "HiFiGANGenerator": jax_params_to_state_dict,
        "MelGANGenerator": jax_melgan_generator_to_state_dict,
        "ParallelWaveGANGenerator": jax_pwg_generator_to_state_dict,
        "StyleMelGANGenerator": jax_style_melgan_generator_to_state_dict,
        "GBlockGenerator": jax_gblock_generator_to_state_dict}
    if generator_type in plain:
        return plain[generator_type](params, generator_params)
    if generator_type in ("BiGRU", "Transformer"):
        if not mutables:
            raise ValueError(f"a JAX {generator_type} checkpoint without its "
                             "BatchNorm statistics (mutables)")
        if generator_type == "BiGRU":
            return jax_bigru_to_state_dict(params, mutables, generator_params,
                                           steps)
        return jax_transformer_to_state_dict(params, mutables,
                                             generator_params, steps)
    raise NotImplementedError(f"carrying a JAX {generator_type} is not "
                              "ported")


def discriminator_to_state_dict(discriminator_type: str,
                                params: Mapping[str, Any],
                                discriminator_params: Mapping[str, Any]
                                ) -> dict[str, torch.Tensor]:
    """Any ported JAX discriminator's params -> the port's state dict."""
    converters = {
        "HiFiGANMultiScaleMultiPeriodDiscriminator": jax_msmpd_to_state_dict,
        "MelGANDiscriminator": jax_melgan_discriminator_to_state_dict,
        "MelGANMultiScaleDiscriminator": jax_melgan_msd_to_state_dict,
        "StyleMelGANDiscriminator":
            jax_style_melgan_discriminator_to_state_dict,
        "ParallelWaveGANDiscriminator": jax_pwg_discriminator_to_state_dict,
        "ResidualParallelWaveGANDiscriminator":
            jax_residual_pwg_discriminator_to_state_dict}
    if discriminator_type not in converters:
        raise NotImplementedError(f"carrying a JAX {discriminator_type} is "
                                  "not ported")
    return converters[discriminator_type](params, discriminator_params)


# The inverse: a reference (or port) state dict -> the JAX package's param
# tree and BatchNorm statistics, as its ``utils/torch_import.py`` builds
# them (the default direction of ``bin/convert_checkpoint.py``).


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class _Keys:
    """A flat torch state dict read into JAX layouts."""

    def __init__(self, sd: Mapping[str, Any]):
        self.sd = {k: _np(v) for k, v in sd.items()}

    def has(self, name: str) -> bool:
        return name in self.sd

    def _bias(self, out: dict, prefix: str) -> dict:
        if f"{prefix}.bias" in self.sd:
            out["b"] = self.sd[f"{prefix}.bias"]
        return out

    def conv1d(self, prefix: str) -> dict:
        """(C_out, C_in, K) -> (K, C_in, C_out), weight norm kept as (g, v)."""
        if f"{prefix}.weight_v" in self.sd:
            out = {"v": np.transpose(self.sd[f"{prefix}.weight_v"], (2, 1, 0)),
                   "g": np.transpose(self.sd[f"{prefix}.weight_g"], (2, 1, 0))}
        else:
            out = {"w": np.transpose(self.sd[f"{prefix}.weight"], (2, 1, 0))}
        return self._bias(out, prefix)

    def conv_transpose1d(self, prefix: str) -> dict:
        """(C_in, C_out, K) -> time-flipped (K, C_in, C_out)."""
        if f"{prefix}.weight_v" in self.sd:
            v = self.sd[f"{prefix}.weight_v"]
            out = {"v": np.transpose(v[:, :, ::-1], (2, 0, 1)).copy(),
                   "g": np.transpose(self.sd[f"{prefix}.weight_g"], (2, 0, 1))}
        else:
            w = self.sd[f"{prefix}.weight"]
            out = {"w": np.transpose(w[:, :, ::-1], (2, 0, 1)).copy()}
        return self._bias(out, prefix)

    def conv2d(self, prefix: str) -> dict:
        """(C_out, C_in, Kh, Kw) -> (Kh, Kw, C_in, C_out)."""
        out = {}
        for src, dst in (("weight_v", "v"), ("weight_g", "g"),
                         ("weight", "w")):
            if f"{prefix}.{src}" in self.sd:
                out[dst] = np.transpose(self.sd[f"{prefix}.{src}"],
                                        (2, 3, 1, 0))
        return self._bias(out, prefix)

    def linear(self, prefix: str) -> dict:
        return self._bias({"w": np.transpose(self.sd[f"{prefix}.weight"],
                                             (1, 0))}, prefix)

    def embedding(self, prefix: str) -> dict:
        return {"w": self.sd[f"{prefix}.weight"]}

    def batch_norm(self, prefix: str) -> tuple[dict, dict]:
        """(params, batch_stats) of a BatchNorm."""
        return ({"scale": self.sd[f"{prefix}.weight"],
                 "bias": self.sd[f"{prefix}.bias"]},
                {"mean": self.sd[f"{prefix}.running_mean"],
                 "var": self.sd[f"{prefix}.running_var"]})

    def ar_model(self) -> dict:
        return {f"fc{li}": self.linear(f"ar_model.model.{ti}")
                for li, ti in enumerate([0, 2, 4, 6, 8])}


def hifigan_generator_to_jax(state_dict: Mapping[str, Any],
                             generator_params: Mapping[str, Any]) -> dict:
    """``HiFiGANGenerator`` (the AR, speaker and phoneme leaves and the
    multi-band form included) -> the JAX param tree."""
    sd = _Keys(state_dict)
    gp = generator_params
    rks = gp.get("resblock_kernel_sizes", (3, 7, 11))
    rdils = gp.get("resblock_dilations", ((1, 3, 5),) * 3)
    use_additional = gp.get("use_additional_convs", True)
    params: dict[str, Any] = {"input_conv": sd.conv1d("input_conv")}
    for i in range(len(gp.get("upsample_scales", (8, 8, 2, 2)))):
        params[f"upsample_{i}"] = sd.conv_transpose1d(f"upsamples.{i}.1")
        for j in range(len(rks)):
            idx = i * len(rks) + j
            block: dict[str, Any] = {}
            for d in range(len(rdils[j])):
                block[f"convs1_{d}"] = sd.conv1d(f"blocks.{idx}.convs1.{d}.1")
                if use_additional:
                    block[f"convs2_{d}"] = sd.conv1d(
                        f"blocks.{idx}.convs2.{d}.1")
            params[f"block_{i}_{j}"] = block
    params["output_conv"] = sd.conv1d("output_conv.1")
    if gp.get("use_ar", False):
        params["ar_model"] = sd.ar_model()
    if gp.get("use_spk_id", False):
        params["spk_emb_mat"] = sd.embedding("spk_emb_mat")
        params["spk_fc"] = sd.linear("spk_fc")
    if gp.get("use_ph", False):
        params["ph_emb_mat"] = sd.embedding("ph_emb_mat")
    if gp.get("use_ph_loss", False):
        params["ph_fc"] = sd.linear("ph_fc")
    return params


def melgan_generator_to_jax(state_dict: Mapping[str, Any],
                            generator_params: Mapping[str, Any]) -> dict:
    """Non-causal ``MelGANGenerator`` -> the JAX param tree (the JAX
    importer takes no causal one either)."""
    if generator_params.get("use_causal_conv", False):
        raise NotImplementedError("a causal MelGAN has no JAX importer")
    sd = _Keys(state_dict)
    params: dict[str, Any] = {"first_conv": sd.conv1d("melgan.1")}
    idx = 2
    for i in range(len(generator_params.get("upsample_scales", (8, 8, 2, 2)))):
        idx += 1  # the activation
        params[f"upsample_{i}"] = sd.conv_transpose1d(f"melgan.{idx}")
        idx += 1
        for j in range(generator_params.get("stacks", 3)):
            params[f"stack_{i}_{j}"] = {
                "conv_dilated": sd.conv1d(f"melgan.{idx}.stack.2"),
                "conv_out": sd.conv1d(f"melgan.{idx}.stack.4"),
                "conv_skip": sd.conv1d(f"melgan.{idx}.skip_layer")}
            idx += 1
    params["last_conv"] = sd.conv1d(f"melgan.{idx + 2}")  # act, pad, conv
    return params


def _folded_conv2d(sd: _Keys, prefix: str) -> np.ndarray:
    """A weight-normed Conv2d's effective weight in (Kh, Kw, C_in, C_out),
    computed as the JAX importer computes it; the port's own state dict
    holds it already (``weight``)."""
    if f"{prefix}.weight_v" not in sd.sd:
        return np.transpose(sd.sd[f"{prefix}.weight"], (2, 3, 1, 0))
    v = sd.sd[f"{prefix}.weight_v"]
    g = sd.sd[f"{prefix}.weight_g"]
    norm = np.sqrt((v ** 2).sum(axis=(1, 2, 3), keepdims=True))
    return np.transpose(g * v / norm, (2, 3, 1, 0))


def pwg_generator_to_jax(state_dict: Mapping[str, Any],
                         generator_params: Mapping[str, Any]) -> dict:
    """``ParallelWaveGANGenerator`` -> the JAX param tree (its upsampling
    Conv2d weights folded to effective weights, JAX's layout)."""
    sd = _Keys(state_dict)
    up = generator_params.get("upsample_params",
                              {"upsample_scales": [4, 4, 4, 4]})
    stride = 3 if up.get("nonlinear_activation") is not None else 2
    params: dict[str, Any] = {"first_conv": sd.conv1d("first_conv")}
    if generator_params.get("upsample_conditional_features", True):
        params["upsample_net"] = {
            "conv_in": sd.conv1d("upsample_net.conv_in"),
            "upsample": {
                f"conv_{i}_w": _folded_conv2d(
                    sd, f"upsample_net.upsample.up_layers.{1 + i * stride}")
                for i in range(len(up.get("upsample_scales",
                                          [4, 4, 4, 4])))}}
    for i in range(generator_params.get("layers", 30)):
        params[f"conv_layer_{i}"] = {
            name: sd.conv1d(f"conv_layers.{i}.{name}") for name in
            ("conv", "conv1x1_aux", "conv1x1_skip", "conv1x1_out")}
    params["last_conv_0"] = sd.conv1d("last_conv_layers.1")
    params["last_conv_1"] = sd.conv1d("last_conv_layers.3")
    return params


def style_melgan_generator_to_jax(state_dict: Mapping[str, Any],
                                  generator_params: Mapping[str, Any]
                                  ) -> dict:
    sd = _Keys(state_dict)
    gp = generator_params
    params: dict[str, Any] = {}
    for i in range(len(gp.get("noise_upsample_scales", (11, 2, 2, 2)))):
        params[f"noise_upsample_{i}"] = sd.conv_transpose1d(
            f"noise_upsample.{2 * i}")
    for i in range(len(gp.get("upsample_scales",
                              (2, 2, 2, 2, 2, 2, 2, 2, 1)))):
        b = f"blocks.{i}"
        params[f"block_{i}"] = {
            "tade1": {"aux_conv": sd.conv1d(f"{b}.tade1.aux_conv.0"),
                      "gated_conv": sd.conv1d(f"{b}.tade1.gated_conv.0")},
            "gated_conv1": sd.conv1d(f"{b}.gated_conv1"),
            "tade2": {"aux_conv": sd.conv1d(f"{b}.tade2.aux_conv.0"),
                      "gated_conv": sd.conv1d(f"{b}.tade2.gated_conv.0")},
            "gated_conv2": sd.conv1d(f"{b}.gated_conv2")}
    params["output_conv"] = sd.conv1d("output_conv.0")
    return params


def gblock_generator_to_jax(state_dict: Mapping[str, Any],
                            generator_params: Mapping[str, Any]) -> dict:
    sd = _Keys(state_dict)
    params: dict[str, Any] = {"input_conv": sd.conv1d("input_conv")}
    for i, scale in enumerate(generator_params.get("g_scales", (8, 8, 2, 2))):
        r = f"resamples.{i}"
        off = 1 if scale > 1 else 0  # the Upsample layer shifts the keys
        params[f"resample_{i}"] = {
            "conv1_a": sd.conv1d(f"{r}.conv1.{1 + off}"),
            "conv1_b": sd.conv1d(f"{r}.conv1.{3 + off}"),
            "res1": sd.conv1d(f"{r}.res1.{off}"),
            "conv2_a": sd.conv1d(f"{r}.conv2.1"),
            "conv2_b": sd.conv1d(f"{r}.conv2.3")}
    params["output_conv"] = sd.conv1d("output_conv.1")
    if generator_params.get("use_ar", False):
        params["ar_model"] = sd.ar_model()
    if generator_params.get("use_spk_id", False):
        params["spk_emb_mat"] = sd.embedding("spk_emb_mat")
        params["spk_fc"] = sd.linear("spk_fc")
    return params


def _gru(sd: _Keys, prefix: str, reverse: bool) -> dict:
    sfx = "_reverse" if reverse else ""
    return {"w_ih": sd.sd[f"{prefix}.weight_ih_l0{sfx}"],
            "w_hh": sd.sd[f"{prefix}.weight_hh_l0{sfx}"],
            "b_ih": sd.sd[f"{prefix}.bias_ih_l0{sfx}"],
            "b_hh": sd.sd[f"{prefix}.bias_hh_l0{sfx}"]}


def bigru_to_jax(state_dict: Mapping[str, Any],
                 generator_params: Mapping[str, Any]) -> tuple[dict, dict]:
    """``BiGRU`` -> (params, ``{"batch_stats": {"bn": ...}}``)."""
    sd = _Keys(state_dict)
    params: dict[str, Any] = {
        name: {"fwd": _gru(sd, name, False), "bwd": _gru(sd, name, True)}
        for name in ("gru1", "gru2")}
    params["fc1"] = sd.linear("fc1.0")
    params["bn"], stats = sd.batch_norm("bn")
    params["fc2"] = sd.linear("fc2.0" if sd.has("fc2.0.weight") else "fc2")
    if generator_params.get("use_ar", False):
        params["ar_model"] = sd.ar_model()
    if generator_params.get("use_spk_emb", False):
        params["spk_fc"] = sd.linear("spk_fc")
    return params, {"batch_stats": {"bn": stats}}


def transformer_to_jax(state_dict: Mapping[str, Any],
                       generator_params: Mapping[str, Any]
                       ) -> tuple[dict, dict]:
    """Gaddy & Klein ``Transformer`` -> (params, ``{"batch_stats": ...}``)."""
    sd = _Keys(state_dict)
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    base = 0
    if generator_params.get("extra_art", False):
        params["front_conv"] = sd.conv1d("conv_blocks.0")
        base = 1
    for i in range(3):
        prefix = f"conv_blocks.{base + i}"
        p: dict[str, Any] = {"conv1": sd.conv1d(f"{prefix}.conv1"),
                             "conv2": sd.conv1d(f"{prefix}.conv2")}
        s: dict[str, Any] = {}
        for bn in ("bn1", "bn2"):
            p[bn], s[bn] = sd.batch_norm(f"{prefix}.{bn}")
        if sd.has(f"{prefix}.residual_path.weight"):
            p["residual_path"] = sd.conv1d(f"{prefix}.residual_path")
            p["res_norm"], s["res_norm"] = sd.batch_norm(f"{prefix}.res_norm")
        params[f"res{i}"], stats[f"res{i}"] = p, s
    params["w_raw_in"] = sd.linear("w_raw_in")
    for i in range(generator_params.get("elayers", 6)):
        t = f"transformer.layers.{i}"
        params[f"layer{i}"] = {
            "self_attn": {
                **{k: sd.sd[f"{t}.self_attn.{k}"]
                   for k in ("w_q", "w_k", "w_v", "w_o")},
                "rel_embeddings": sd.sd[
                    f"{t}.self_attn.relative_positional.embeddings"][..., 0]},
            "linear1": sd.linear(f"{t}.linear1"),
            "linear2": sd.linear(f"{t}.linear2"),
            **{norm: {"scale": sd.sd[f"{t}.{norm}.weight"],
                      "bias": sd.sd[f"{t}.{norm}.bias"]}
               for norm in ("norm1", "norm2")}}
    if sd.has("in_emb_mat.weight"):
        params["in_emb_mat"] = sd.embedding("in_emb_mat")
    params["w_out"] = sd.linear("w_out")
    return params, {"batch_stats": stats}


# generator type -> (state dict, generator_params) -> (params, mutables),
# the JAX package's GENERATOR_IMPORTERS
GENERATOR_TO_JAX = {
    "HiFiGANGenerator": lambda sd, gp: (hifigan_generator_to_jax(sd, gp), {}),
    "MelGANGenerator": lambda sd, gp: (melgan_generator_to_jax(sd, gp), {}),
    "ParallelWaveGANGenerator": lambda sd, gp: (
        pwg_generator_to_jax(sd, gp), {}),
    "StyleMelGANGenerator": lambda sd, gp: (
        style_melgan_generator_to_jax(sd, gp), {}),
    "GBlockGenerator": lambda sd, gp: (gblock_generator_to_jax(sd, gp), {}),
    "BiGRU": bigru_to_jax,
    "Transformer": transformer_to_jax,
}


def _melgan_discriminator_to_jax(sd: _Keys, prefix: str,
                                 discriminator_params: Mapping[str, Any]
                                 ) -> dict:
    n_down = len(discriminator_params.get("downsample_scales", (4, 4, 4, 4)))
    disc: dict[str, Any] = {"layer_0": sd.conv1d(f"{prefix}.layers.0.1")}
    for k in range(1, n_down + 2):
        disc[f"layer_{k}"] = sd.conv1d(f"{prefix}.layers.{k}.0")
    disc[f"layer_{n_down + 2}"] = sd.conv1d(f"{prefix}.layers.{n_down + 2}")
    return disc


def msmpd_to_jax(state_dict: Mapping[str, Any],
                 discriminator_params: Mapping[str, Any]) -> dict:
    """``HiFiGANMultiScaleMultiPeriodDiscriminator`` -> ``{"msd", "mpd"}``."""
    sd = _Keys(state_dict)
    dp = discriminator_params
    n_scale_layers = len(dp.get("scale_discriminator_params", {}).get(
        "downsample_scales", (2, 2, 4, 4, 1))) + 3
    n_period_convs = len(dp.get("period_discriminator_params", {}).get(
        "downsample_scales", (3, 3, 3, 3, 1)))
    msd: dict[str, Any] = {}
    for i in range(dp.get("scales", 3)):
        disc: dict[str, Any] = {}
        for k in range(n_scale_layers):
            prefix = f"msd.discriminators.{i}.layers.{k}"
            # Sequential(conv, act) but for the last layer, a bare conv
            disc[f"layer_{k}"] = sd.conv1d(
                f"{prefix}.0" if sd.has(f"{prefix}.0.weight") else prefix)
        msd[f"disc_{i}"] = disc
    mpd: dict[str, Any] = {}
    for i in range(len(dp.get("periods", (2, 3, 5, 7, 11)))):
        disc = {f"conv_{k}": sd.conv2d(f"mpd.discriminators.{i}.convs.{k}.0")
                for k in range(n_period_convs)}
        disc["output_conv"] = sd.conv2d(f"mpd.discriminators.{i}.output_conv")
        mpd[f"disc_{i}"] = disc
    return {"msd": msd, "mpd": mpd}


def melgan_msd_to_jax(state_dict: Mapping[str, Any],
                      discriminator_params: Mapping[str, Any]) -> dict:
    sd = _Keys(state_dict)
    return {f"disc_{i}": _melgan_discriminator_to_jax(
        sd, f"discriminators.{i}", discriminator_params)
        for i in range(discriminator_params.get("scales", 3))}


def style_melgan_discriminator_to_jax(
        state_dict: Mapping[str, Any],
        discriminator_params: Mapping[str, Any]) -> dict:
    sd = _Keys(state_dict)
    inner = discriminator_params.get("discriminator_params", {})
    return {f"disc_{i}": _melgan_discriminator_to_jax(
        sd, f"discriminators.{i}", inner)
        for i in range(len(discriminator_params.get("pqmf_params",
                                                    ((1,),) * 4)))}


def pwg_discriminator_to_jax(state_dict: Mapping[str, Any],
                             discriminator_params: Mapping[str, Any]) -> dict:
    sd = _Keys(state_dict)
    return {f"conv_{i}": sd.conv1d(f"conv_layers.{2 * i}")
            for i in range(discriminator_params.get("layers", 10))}


# the JAX package's DISCRIMINATOR_IMPORTERS
DISCRIMINATOR_TO_JAX = {
    "HiFiGANMultiScaleMultiPeriodDiscriminator": msmpd_to_jax,
    "MelGANMultiScaleDiscriminator": melgan_msd_to_jax,
    "StyleMelGANDiscriminator": style_melgan_discriminator_to_jax,
    "ParallelWaveGANDiscriminator": pwg_discriminator_to_jax,
}


def fold_weight_norm(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Fold every ``weight_g`` / ``weight_v`` pair of a state dict; other
    entries pass through. The norm runs over the axes where g has size 1."""
    out = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    for key in state_dict:
        if not key.endswith(".weight_g"):
            continue
        prefix = key[: -len("_g")]
        g_t, v_t = out[f"{prefix}_g"], out[f"{prefix}_v"]
        g = g_t.detach().cpu().numpy()
        v = v_t.detach().cpu().numpy()
        axes = tuple(i for i, s in enumerate(g.shape) if s == 1)
        w_eff = g * v / np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
        new_g = np.sqrt(np.sum(w_eff * w_eff, axis=axes, keepdims=True))
        out[f"{prefix}_v"] = torch.from_numpy(w_eff.astype(v.dtype)).to(v_t.device)
        out[f"{prefix}_g"] = torch.from_numpy(new_g.astype(g.dtype)).to(g_t.device)
    return out


# Tensor parallelism (parallel/tp.py): how a HiFi-GAN generator's full state
# dict lies over the ranks of a TP group, and its split and gather.

_UPSAMPLE = re.compile(r"upsamples\.(\d+)\.1\.(weight_v|weight_g|weight)$")
_BLOCK = re.compile(r"blocks\.(\d+)\.")
_CONV_IN = re.compile(r"(input_conv|output_conv\.1)\.(weight_v|weight)$")


def channel_ranges(channels: int, size: int) -> list[tuple[int, int]]:
    """``size`` contiguous ranges over ``channels``, differing by at most
    one channel."""
    if channels < size:
        raise ValueError(f"{channels} channels cannot be split {size} ways")
    base, extra = divmod(channels, size)
    out, start = [], 0
    for r in range(size):
        stop = start + base + (1 if r < extra else 0)
        out.append((start, stop))
        start = stop
    return out


def block_owners(kernel_sizes, size: int) -> list[int]:
    """The rank of each MRF block: the largest kernels first, each to the
    rank with the fewest taps so far (ties to the higher rank)."""
    if size > len(kernel_sizes):
        raise ValueError(f"tensor_parallel {size} exceeds the MRF's "
                         f"{len(kernel_sizes)} residual blocks")
    load = [0] * size
    owners = [0] * len(kernel_sizes)
    for j in sorted(range(len(kernel_sizes)),
                    key=lambda j: (-kernel_sizes[j], j)):
        r = min(range(size), key=lambda r: (load[r], -r))
        owners[j] = r
        load[r] += kernel_sizes[j]
    return owners


def tp_key_spec(key: str, shape, size: int, num_blocks: int,
                owners: list[int]):
    """How the full state-dict entry ``key`` (of ``shape``) lies over a TP
    group of ``size``: ``("split", dim)``, ``("owned", rank)`` or
    ``("replicated",)``. A conv with fewer input channels than ranks stays
    replicated."""
    for pattern, dim in ((_CONV_IN, 1), (_UPSAMPLE, 0)):
        if pattern.match(key):
            return ("split", dim) if shape[dim] >= size else ("replicated",)
    m = _BLOCK.match(key)
    if m:
        return ("owned", owners[int(m.group(1)) % num_blocks])
    return ("replicated",)


def tp_part(t: torch.Tensor, spec, rank: int, size: int) -> torch.Tensor | None:
    if spec[0] == "split":
        start, stop = channel_ranges(t.shape[spec[1]], size)[rank]
        return t.narrow(spec[1], start, stop - start)
    if spec[0] == "owned":
        return t if spec[1] == rank else None
    return t


def _plan_args(gp: dict) -> tuple[int, list[int]]:
    kernels = list(gp.get("resblock_kernel_sizes", (3, 7, 11)))
    return len(kernels), kernels


def split_tp_state_dict(sd: dict, generator_params: dict, rank: int, size: int
                     ) -> dict:
    """The entries of a full generator state dict that rank ``rank`` of a
    TP group of ``size`` holds (the blocks of other ranks left out)."""
    nb, kernels = _plan_args(generator_params)
    owners = block_owners(kernels, size)
    out = {}
    for key, t in sd.items():
        part = tp_part(t, tp_key_spec(key, t.shape, size, nb, owners), rank,
                       size)
        if part is not None:
            out[key] = part.clone()
    return out


def _in_channels(key: str, gp: dict) -> int:
    """The input channels of the HiFi-GAN conv that ``key`` belongs to."""
    channels = gp.get("channels", 512)
    m = _UPSAMPLE.match(key)
    if m:
        return channels // 2 ** int(m.group(1))
    if key.startswith("output_conv"):
        return channels // 2 ** len(gp.get("upsample_scales", (8, 8, 2, 2)))
    if key.startswith("input_conv"):
        return gp.get("in_channels", 80) + (gp.get("ph_emb_size", 8)
                                            if gp.get("use_ph") else 0)
    return 0


def gather_tp_state_dicts(sds: list[dict], generator_params: dict) -> dict:
    """The full generator state dict from every rank's (``sds[r]`` rank
    r's), in the generator's module order."""
    size = len(sds)
    nb, kernels = _plan_args(generator_params)
    owners = block_owners(kernels, size)
    keys = list(dict.fromkeys(k for sd in sds for k in sd))
    keys.sort(key=_generator_key_order)
    out = {}
    for key in keys:
        held = next(sd[key] for sd in sds if key in sd)
        shape = list(held.shape)
        if held.dim() >= 2:  # a conv weight: the full input channel count
            shape[1 if _CONV_IN.match(key) else 0] = _in_channels(
                key, generator_params)
        spec = tp_key_spec(key, shape, size, nb, owners)
        if spec[0] == "split":
            out[key] = torch.cat([sd[key] for sd in sds], dim=spec[1])
        elif spec[0] == "owned":
            out[key] = sds[spec[1]][key]
        else:
            out[key] = sds[0][key]
    return out


def _generator_key_order(key: str):
    """A generator's module order (the conditioning, the input conv, the
    upsamplers, the blocks, the output conv) and the module's index; a
    stable sort keeps a module's own key order."""
    head = key.split(".")[0]
    order = ["ar_model", "input_conv", "upsamples", "blocks", "output_conv",
             "spk_emb_mat", "spk_fc", "ph_emb_mat", "ph_fc"]
    nums = [int(n) for n in re.findall(r"\.(\d+)\.", "." + key + ".")]
    return (order.index(head) if head in order else len(order), nums[:1])
