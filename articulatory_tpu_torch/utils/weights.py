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
- Dense (in, out) -> (out, in);
- GRU ``w_ih``, ``w_hh``, ``b_ih``, ``b_hh`` (torch's packing already) ->
  ``weight_ih_l0`` ... , ``_reverse`` for the backward direction;
- BatchNorm scale, bias and the running mean and variance -> ``weight``,
  ``bias``, ``running_mean``, ``running_var``;
- weight-norm (g, v) -> ``weight_g`` / ``weight_v`` on torch's axes.

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


def jax_params_to_state_dict(params: Mapping[str, Any],
                             generator_params: Mapping[str, Any]
                             ) -> dict[str, torch.Tensor]:
    """JAX ``HiFiGANGenerator`` params -> the port's state dict."""
    for flag in ("use_spk_id", "use_ph", "use_ph_loss"):
        if generator_params.get(flag, False):
            raise NotImplementedError(f"{flag} is not ported yet")
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
        for li, ti in enumerate([0, 2, 4, 6, 8]):
            _linear(sd, f"ar_model.model.{ti}", params["ar_model"][f"fc{li}"])
    return sd


def jax_bigru_to_state_dict(params: Mapping[str, Any],
                            mutables: Mapping[str, Any],
                            generator_params: Mapping[str, Any]
                            ) -> dict[str, torch.Tensor]:
    """JAX ``BiGRU`` params and mutables (``{"batch_stats": {"bn": {"mean",
    "var"}}}``) -> the port's state dict (the keys of the JAX package's
    ``utils/torch_export.py::export_bigru``)."""
    sd: dict[str, torch.Tensor] = {}
    for name in ("gru1", "gru2"):
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            layer = params[name][direction]
            for src, dst in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                             ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                sd[f"{name}.{dst}_l0{suffix}"] = _tensor(layer[src])
    _linear(sd, "fc1.0", params["fc1"])
    stats = mutables.get("batch_stats", mutables)["bn"]
    sd["bn.weight"] = _tensor(params["bn"]["scale"])
    sd["bn.bias"] = _tensor(params["bn"]["bias"])
    sd["bn.running_mean"] = _tensor(stats["mean"])
    sd["bn.running_var"] = _tensor(stats["var"])
    sd["bn.num_batches_tracked"] = torch.tensor(0)
    _linear(sd, "fc2.0" if generator_params.get("use_tanh", False) else "fc2",
            params["fc2"])
    if generator_params.get("use_ar", False):
        for li, ti in enumerate([0, 2, 4, 6, 8]):
            _linear(sd, f"ar_model.model.{ti}", params["ar_model"][f"fc{li}"])
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
