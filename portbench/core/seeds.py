"""Every random draw of a run comes from ``--seed`` and a tag naming what it
is for, so that the same seed gives the same weights and inputs whatever
else the run does."""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for ``(seed, *tags)``."""
    key = "/".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *tags))


def generator(seed: int, device, *tags) -> torch.Generator:
    return torch.Generator(device).manual_seed(sub_seed(seed, *tags))


def fan_in(shape) -> int:
    """torch's fan-in of a weight: every axis after the first (a transposed
    convolution's (C_in, C_out, K) weight included)."""
    n = 1
    for s in shape[1:]:
        n *= s
    return n


def make_weights(shapes: dict, seed: int, device, tag: str,
                 gains: dict | None = None) -> dict:
    """A state dict of ``shapes`` (name -> shape) drawn on ``device`` in one
    call: kernels and biases U(+-1/sqrt(fan_in)) of the layer's kernel,
    times ``gains[prefix]`` for the names that start with a prefix of it;
    weight-norm gains ``||v|| x U(0.75, 1.25)`` per output. Names end in
    ``weight``, ``weight_v``, ``weight_g`` or ``bias``."""
    total = sum(int(np.prod(s)) for s in shapes.values())
    flat = torch.empty(total, device=device).uniform_(
        -1.0, 1.0, generator=generator(seed, device, "weights", tag))
    state, at = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        state[name] = flat[at:at + n].view(shape)
        at += n
    for name, shape in shapes.items():
        prefix, leaf = name.rsplit(".", 1)
        kernel = shapes.get(f"{prefix}.weight_v", shapes.get(
            f"{prefix}.weight"))
        bound = fan_in(kernel) ** -0.5 * next(
            (g for p, g in (gains or {}).items() if name.startswith(p)), 1.0)
        if leaf in ("weight", "weight_v", "bias"):
            state[name] = state[name] * bound
    for name in shapes:
        prefix, leaf = name.rsplit(".", 1)
        if leaf == "weight_g":
            v = state[f"{prefix}.weight_v"]
            norm = v.square().sum(dim=tuple(range(1, v.dim())),
                                  keepdim=True).sqrt()
            state[name] = norm * (1.0 + 0.25 * state[name])
    return state
