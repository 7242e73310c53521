"""Model registry: YAML class names -> the port's modules.

This slice ports ``HiFiGANGenerator`` only; other names raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from articulatory_tpu_torch.models.hifigan import HiFiGANGenerator

_REGISTRY = {"HiFiGANGenerator": HiFiGANGenerator}
_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "f32": torch.float32, "fp32": torch.float32,
           "float32": torch.float32}


def build_model(name: str, params: dict | None, seed: int = 0):
    """Instantiate a registered model from YAML kwargs (lists -> tuples;
    ``compute_dtype`` strings like "bfloat16" -> torch dtypes). ``seed``
    seeds the initial weights."""
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"{name!r} is not ported yet; ported: {sorted(_REGISTRY)}")

    def freeze(k, v):
        if isinstance(v, list):
            return tuple(freeze(k, x) for x in v)
        if k == "compute_dtype" and isinstance(v, str):
            if v not in _DTYPES:
                raise ValueError(f"unsupported compute_dtype {v!r}")
            return _DTYPES[v]
        if isinstance(v, dict):
            return {kk: freeze(kk, vv) for kk, vv in v.items()}
        return v

    kwargs = {k: freeze(k, v) for k, v in dict(params or {}).items()}
    return _REGISTRY[name](**kwargs, seed=seed)
