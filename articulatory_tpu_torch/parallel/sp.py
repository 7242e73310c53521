"""Sequence parallelism: time tiles of a long full-utterance forward (port
of ``articulatory_tpu/parallel/sp.py`` and ``inference.py::
enable_sequence_parallel``).

JAX shards the time axis of the input over n devices and GSPMD exchanges
the halos between neighbouring shards. The port cuts the (zero-padded)
utterance into n time tiles, each extended by a halo of at least the
generator's receptive field in frames (``receptive_field_frames``, from the
config: the input conv, each upsampler's kernel over its stride, the MRF's
widest K x d sum and the output conv), runs tile i on ``devices[i]``, and
keeps each tile's own frames of the output: every kept sample sees the same
inputs as in the unsharded forward. Each device holds one tile's
activations at a time, which bounds the memory of very long utterances;
with the default devices (the model's, n times) the tiles run one after
another on one card.

As in JAX the frame count is zero-padded up to a multiple of n and the
output trimmed back, so the result is the padded forward's: only the last
receptive-field window can differ from an exact-length forward. Only the
non-AR full-utterance forward of a ``HiFiGANGenerator`` is tiled; a forward
fed an AR carry takes the unsharded path.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def receptive_field_frames(generator_params: dict) -> int:
    """A bound on how many input frames on either side a HiFi-GAN output
    sample depends on."""
    gp = generator_params
    k = gp.get("kernel_size", 7)
    scales = gp.get("upsample_scales", (8, 8, 2, 2))
    up_kernels = gp.get("upsample_kernel_sizes", (16, 16, 4, 4))
    kernels = gp.get("resblock_kernel_sizes", (3, 7, 11))
    dilations = gp.get("resblock_dilations", ((1, 3, 5),) * 3)
    extra = 1 if gp.get("use_additional_convs", True) else 0
    mrf = max(sum((rk - 1) // 2 * (d + extra) for d in ds)
              for rk, ds in zip(kernels, dilations))
    frames, rate = (k - 1) // 2, 1
    for s, uk in zip(scales, up_kernels):
        frames += math.ceil(uk / s) + 1  # a transposed conv's reach
        rate *= s
        frames += math.ceil(mrf / rate)
    return frames + math.ceil(((k - 1) // 2) / rate) + 1


class SequenceParallel:
    """``n`` time tiles of ``model``'s forward, tile i on ``devices[i]``
    (a copy of the model on each device other than its own), with a halo
    of ``halo`` frames."""

    def __init__(self, model: nn.Module, n: int, halo: int,
                 devices: Sequence | None = None):
        if n < 1:
            raise ValueError(f"sequence parallelism needs n >= 1, got {n}")
        home = next(model.parameters()).device
        self.devices = [torch.device(d) for d in
                        (devices if devices is not None else [home] * n)]
        if len(self.devices) < n:
            raise ValueError(f"{len(self.devices)} devices for {n} tiles")
        self.n, self.halo, self.home = n, halo, home
        self.replicas = {home: model}
        for d in self.devices[:n]:
            if d not in self.replicas:
                self.replicas[d] = copy.deepcopy(model).to(d)

    def __call__(self, c: torch.Tensor,
                 forward: Callable[[nn.Module, torch.Tensor], torch.Tensor]
                 ) -> torch.Tensor:
        """``forward(model, c)`` over the tiles of ``c`` (B, T, C): the
        padded forward's output, trimmed to T frames' worth."""
        t = c.shape[1]
        pad = -t % self.n
        if pad:
            c = F.pad(c.transpose(1, 2), (0, pad)).transpose(1, 2)
        total = c.shape[1]
        tile = total // self.n
        outs = []
        for i, dev in enumerate(self.devices[:self.n]):
            start, stop = i * tile, (i + 1) * tile
            lo, hi = max(0, start - self.halo), min(total, stop + self.halo)
            y = forward(self.replicas[dev], c[:, lo:hi].to(dev))
            rate = y.shape[1] // (hi - lo)
            outs.append(y[:, (start - lo) * rate:(stop - lo) * rate]
                        .to(self.home))
        out = torch.cat(outs, dim=1)
        if pad:
            out = out[:, : out.shape[1] * t // total]
        return out
