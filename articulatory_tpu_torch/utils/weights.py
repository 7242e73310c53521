"""Weights carried across from the JAX package's parameter trees.

``jax_params_to_state_dict`` turns the JAX ``HiFiGANGenerator`` param tree
(nested dicts of numpy arrays) into the port's ``state_dict``, which has the
reference's torch keys and layouts:

- Conv1d (K, C_in, C_out) -> (C_out, C_in, K);
- ConvTranspose1d (K, C_in, C_out), time-flipped -> (C_in, C_out, K),
  un-flipped;
- Dense (in, out) -> (out, in);
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
    return torch.tensor(np.ascontiguousarray(a))


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
