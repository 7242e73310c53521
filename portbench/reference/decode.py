"""The output check of a chunked-AR decode, and the reference's own loop.

The decode feeds each chunk the tail of its previous output (the AR
carry), which the loop amplifies: a rounding in one chunk moves every later
one. So the check follows the served output as a served language model's
tokens are followed: chunk k of a lane is recomputed by the reference from
its feature frames and the carry that the served chunk k-1 ends with (zeros
for chunk 0), and compared with served chunk k. A carry the program got
wrong, or a chunk it computed wrongly, shows in the chunk that follows;
rounding does not compound. A lane's input is zero-padded to whole chunks,
as the batched loop pads it, and only its real samples are compared.

Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.hifigan import generator, no_tf32

# reference chunk forwards a block: samples of output per block
BLOCK_SAMPLES = 2 ** 19


def chunking(model: dict) -> tuple[int, int, int]:
    """(frames a chunk, samples a chunk, carry samples); the carry must be
    the previous chunk's tail."""
    gp = model["generator_params"]
    frames = model["batch_max_steps"] // model["hop_size"]
    samples = frames * model["hop_size"]
    carry = gp["ar_input"]
    if carry > samples:
        raise ValueError("the check takes a carry within one chunk")
    return frames, samples, carry


def _items(model: dict, lanes: list):
    """(lane, chunk, features, carry) for every chunk of every lane, and
    the lanes whose output is not a finite waveform of their length."""
    frames, samples, carry = chunking(model)
    hop = model["hop_size"]
    items, bad = [], []
    for i, (x, out) in enumerate(lanes):
        if out.shape != (len(x) * hop,) or not np.isfinite(out).all():
            bad.append(i)
            continue
        for k in range(math.ceil(len(x) / frames)):
            feats = np.zeros((frames, x.shape[1]), np.float32)
            part = x[k * frames:(k + 1) * frames]
            feats[:len(part)] = part
            past = (np.zeros(carry, np.float32) if k == 0
                    else out[k * samples - carry:k * samples])
            items.append((i, k, feats, past))
    return items, bad


def teacher_forced_gap(weights: dict, model: dict, lanes: list,
                       precision: str, device) -> dict:
    """``lanes``: (features (T, F), served waveform (T * hop,)) each. The
    widest gap between a served sample and the reference's, the samples
    compared, and the lanes whose output is missing or not finite (their
    gap counts as infinite)."""
    gp = model["generator_params"]
    _, samples, _ = chunking(model)
    items, bad = _items(model, lanes)
    block = max(1, BLOCK_SAMPLES // samples)
    gap, compared = 0.0, 0
    with torch.no_grad(), no_tf32():
        for at in range(0, len(items), block):
            part = items[at:at + block]
            c = torch.from_numpy(np.stack([p[2] for p in part])).to(device)
            ar = torch.from_numpy(np.stack([p[3] for p in part])).to(device)
            ref = generator(weights, gp, c, ar, precision).cpu().numpy()
            for (i, k, _, _), r in zip(part, ref):
                served = lanes[i][1][k * samples:(k + 1) * samples]
                gap = max(gap, float(np.abs(served - r[:len(served)]).max()))
                compared += len(served)
    return {"gap": math.inf if bad else gap, "compared": compared,
            "bad_lanes": len(bad)}


def free_run(weights: dict, model: dict, xs: list, precision: str,
             device) -> list[np.ndarray]:
    """The reference's own chunked-AR decode of ``xs`` (features (T, F)
    each), all lanes at once, zero-padded to whole chunks; each lane's
    waveform trimmed to its length. The control of the output check runs
    it in a lower precision."""
    gp = model["generator_params"]
    frames, samples, carry = chunking(model)
    hop = model["hop_size"]
    n = max(math.ceil(len(x) / frames) for x in xs)
    batch = np.zeros((len(xs), n * frames, xs[0].shape[1]), np.float32)
    for i, x in enumerate(xs):
        batch[i, :len(x)] = x
    c = torch.from_numpy(batch).to(device)
    past = torch.zeros((len(xs), carry), device=device)
    outs = []
    with torch.no_grad(), no_tf32():
        for k in range(n):
            out = generator(weights, gp, c[:, k * frames:(k + 1) * frames],
                            past, precision)
            past = out[:, -carry:]
            outs.append(out)
    wave = torch.cat(outs, 1).cpu().numpy()
    return [wave[i, :len(x) * hop] for i, x in enumerate(xs)]
