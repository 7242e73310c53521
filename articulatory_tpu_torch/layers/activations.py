"""Activation resolver: ``getattr(torch.nn, name)(**params)`` semantics as
functions (port of ``articulatory_tpu/layers/activations.py``)."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def get_activation(name: str, params: dict | None = None
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    params = params or {}
    if name == "LeakyReLU":
        slope = params.get("negative_slope", 0.01)
        return lambda x: F.leaky_relu(x, slope)
    if name == "ReLU":
        return F.relu
    if name == "Tanh":
        return torch.tanh
    if name == "GELU":
        return F.gelu  # exact erf form, torch.nn.GELU's default
    if name == "ELU":
        alpha = params.get("alpha", 1.0)
        return lambda x: F.elu(x, alpha)
    if name == "SELU":
        return F.selu
    if name == "Softplus":
        beta = params.get("beta", 1.0)
        threshold = params.get("threshold", 20.0)
        return lambda x: F.softplus(x, beta, threshold)
    if name == "Sigmoid":
        return torch.sigmoid
    raise ValueError(f"Unsupported activation: {name}")
