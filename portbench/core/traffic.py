"""The one traffic generator: utterance lengths and articulatory features,
from the seed and the parameters of a ``traffic/<name>.json`` file.

Lengths are stratified: each group of ``count`` utterances (a batch, or a
block of single utterances) takes one length from each of ``count`` equal
strata of ``[lo, hi]`` seconds, in an order drawn from the seed. Every seed
so draws the same spread of work, and the seed changes which utterance is
long, not how much there is.

Features are smoothed normal noise (a 9-frame box filter over N(0, 1),
unit variance), the shape of normalised articulatory trajectories, made on
the card in one call for a pool of ``pool`` x ``count`` utterances at the
longest length and copied to the host once; an utterance reads a prefix of
its pool row.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.core import seeds

SMOOTH_FRAMES = 9


def features(model: dict) -> int:
    """Feature channels a frame: the generator's inputs less the AR
    features it makes itself."""
    gp = model["generator_params"]
    return gp["in_channels"] - (gp["ar_output"] if gp.get("use_ar") else 0)


def checked(sizes: list, count: int, seed: int) -> list[int]:
    """The indices the output check follows: the largest of ``sizes``
    first, then ``count - 1`` others drawn from the seed."""
    longest = int(np.argmax(sizes))
    rest = [j for j in range(len(sizes)) if j != longest]
    n = min(count - 1, len(rest))
    return [longest] + [int(j) for j in seeds.rng(seed, "check").choice(
        rest, size=n, replace=False)]


def frames_per_second(model: dict) -> float:
    return model["sampling_rate"] / model["hop_size"]


def max_frames(traffic: dict, model: dict) -> int:
    return math.ceil(traffic["seconds"][1] * frames_per_second(model))


def stratified_frames(seed: int, group: int, count: int, traffic: dict,
                      model: dict) -> np.ndarray:
    """Frame counts of the ``count`` utterances of group ``group``."""
    lo, hi = traffic["seconds"]
    rng = seeds.rng(seed, "lengths", group)
    order = rng.permutation(count)
    sec = lo + (hi - lo) * (order + rng.random(count)) / count
    frames = np.floor(sec * frames_per_second(model)).astype(np.int64)
    return np.clip(frames, 1, max_frames(traffic, model))


def feature_pool(seed: int, rows: int, frames: int, feat: int,
                 device) -> np.ndarray:
    """(rows, frames, feat) float32 on the host."""
    g = seeds.generator(seed, device, "features")
    z = torch.randn((rows, feat, frames + SMOOTH_FRAMES - 1), generator=g,
                    device=device)
    box = torch.full((feat, 1, SMOOTH_FRAMES), SMOOTH_FRAMES ** -0.5,
                     device=device)
    x = F.conv1d(z, box, groups=feat)
    return np.ascontiguousarray(x.transpose(1, 2).cpu().numpy())
