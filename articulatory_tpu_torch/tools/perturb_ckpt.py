#!/usr/bin/env python3
"""Write a copy of a checkpoint with its generator's floating-point leaves
scaled by ``1 + scale`` (default one float32 ulp, 2**-23; port of
``tools/perturb_ckpt.py``).

The noise-cone arm of every quality A/B (``bf16_quality_ab.sh``,
``int8_quality_ab.sh``, ``bf16_weights_quality_ab.sh``,
``hybrid_train_quality_ab.sh``, ``mri_hybrid_quality_ab.sh`` beside this
file): the chunked-AR decode and GAN training are chaotic, so how far the
f32 path drifts from itself under a 1-ulp change of its weights is the
yardstick a precision variant's divergence is judged against
(docs/DESIGN.md §7-8). Each leaf is multiplied in its own dtype (float32:
``a * float32(1 + scale)``, rounded once). The output keeps the input's
format: a torch pickle stays a pickle (``torch.save``), a JAX msgpack is
written as flax writes it (``utils/checkpoint.py::save_msgpack``), byte for
byte what the JAX package's tool writes.

    python -m articulatory_tpu_torch.tools.perturb_ckpt <in> <out> [--scale S]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from articulatory_tpu_torch.utils.checkpoint import (
    _is_torch_pickle,
    load_checkpoint,
    save_msgpack,
)


def perturb(tree, factor: np.float32):
    """Every floating leaf of ``tree`` times ``factor``, in its dtype."""
    if isinstance(tree, dict):
        return {k: perturb(v, factor) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):  # a cascade's 1-tuple generator2
        return type(tree)(perturb(v, factor) for v in tree)
    if torch.is_tensor(tree):
        if not tree.is_floating_point():
            return tree
        return tree * torch.tensor(factor, dtype=tree.dtype)
    if np.issubdtype(np.asarray(tree).dtype, np.floating):
        return (tree * factor).astype(tree.dtype)
    return tree


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--scale", type=float, default=float(np.float32(2.0 ** -23)),
                   help="relative perturbation (default: 1 f32 ulp)")
    args = p.parse_args(argv)
    ckpt = load_checkpoint(args.src)
    factor = np.float32(1.0 + args.scale)
    ckpt["model"]["generator"] = perturb(ckpt["model"]["generator"], factor)
    if _is_torch_pickle(args.src):
        torch.save(ckpt, args.dst)
    else:
        save_msgpack(args.dst, ckpt)
    print(f"wrote 1-ulp perturbed {args.src} -> {args.dst}")


if __name__ == "__main__":
    main()
