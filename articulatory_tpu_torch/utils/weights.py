"""Weights carried across from the JAX package's parameter trees.

``jax_params_to_state_dict`` turns the JAX ``HiFiGANGenerator`` param tree
(nested dicts of numpy arrays) into the port's ``state_dict``, and
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

``fold_weight_norm`` is ``remove_weight_norm`` on a state dict: each
``weight_v`` becomes the effective weight and ``weight_g`` its norm, so the
forward computes the same kernel from an exactly normalised v.
"""

from __future__ import annotations

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


def jax_params_to_state_dict(params: Mapping[str, Any],
                             generator_params: Mapping[str, Any]
                             ) -> dict[str, torch.Tensor]:
    """JAX ``HiFiGANGenerator`` params -> the port's state dict (the keys
    of the JAX package's ``export_hifigan_generator``, the conditioning
    leaves included)."""
    sd: dict[str, torch.Tensor] = {}
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
        p, s, prefix = params[f"res{i}"], stats[f"res{i}"], \
            f"conv_blocks.{base + i}"
        _conv1d(sd, f"{prefix}.conv1", p["conv1"])
        _conv1d(sd, f"{prefix}.conv2", p["conv2"])
        for bn in ("bn1", "bn2"):
            _batch_norm(sd, f"{prefix}.{bn}", p[bn], s[bn], steps)
        if "residual_path" in p:
            _conv1d(sd, f"{prefix}.residual_path", p["residual_path"])
            _batch_norm(sd, f"{prefix}.res_norm", p["res_norm"],
                        s["res_norm"], steps)
    _linear(sd, "w_raw_in", params["w_raw_in"])
    for i in range(generator_params.get("elayers", 6)):
        t, layer = f"transformer.layers.{i}", params[f"layer{i}"]
        attn = layer["self_attn"]
        for k in ("w_q", "w_k", "w_v", "w_o"):
            sd[f"{t}.self_attn.{k}"] = _tensor(attn[k])
        sd[f"{t}.self_attn.relative_positional.embeddings"] = _tensor(
            np.asarray(attn["rel_embeddings"])[..., None])
        _linear(sd, f"{t}.linear1", layer["linear1"])
        _linear(sd, f"{t}.linear2", layer["linear2"])
        for norm in ("norm1", "norm2"):
            sd[f"{t}.{norm}.weight"] = _tensor(layer[norm]["scale"])
            sd[f"{t}.{norm}.bias"] = _tensor(layer[norm]["bias"])
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
