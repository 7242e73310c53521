#!/usr/bin/env python3
"""Convert checkpoints of the JAX package for the reference (port of
``articulatory_tpu/bin/convert_checkpoint.py``).

``--to-torch``: a JAX msgpack checkpoint becomes a reference-format torch
pickle through the port's own converters (``utils/weights.py``), in the
layout of the JAX package's ``utils/torch_export.py::export_checkpoint``:
``{"model": {"generator"[, "generator2"][, "discriminator"]},
"optimizer": {}, "scheduler": {}, "steps", "epochs"}`` with the
``weight_g`` / ``weight_v`` reparam; a cascade's ``generator2`` as a
1-tuple (the reference's save quirk), the discriminator for the types the
JAX package exports. The reference's ``load_model`` and ``--pretrain``
read it, and so does the port's.

The default direction (a reference pickle to a JAX msgpack) is not ported
and raises: the port reads reference pickles natively, and writing the
JAX layout needs an inverse of every family's converter (ROADMAP A11).

    python -m articulatory_tpu_torch.bin.convert_checkpoint --to-torch \\
        --checkpoint exp/ours/best_mel_ckpt.pkl --out export/ckpt.pkl
"""

from __future__ import annotations

import argparse
import os

import torch

from articulatory_tpu_torch.config import fix_generator_params, load_config
from articulatory_tpu_torch.utils.checkpoint import (
    discriminator_state_dict,
    generator_state_dict,
    load_checkpoint,
)

# the discriminators the JAX package's export_checkpoint writes
EXPORTED_DISCRIMINATORS = (
    "HiFiGANMultiScaleMultiPeriodDiscriminator",
    "MelGANMultiScaleDiscriminator", "StyleMelGANDiscriminator",
    "ParallelWaveGANDiscriminator")


def export_checkpoint(payload: dict, config: dict) -> dict:
    """A checkpoint payload -> the reference's torch-pickle payload."""
    gen_type = config.get("generator_type", "ParallelWaveGANGenerator")
    steps = int(payload.get("steps", 0))
    out = {"model": {"generator": generator_state_dict(
               payload, "generator",
               fix_generator_params(config["generator_params"]), gen_type)},
           "optimizer": {}, "scheduler": {}, "steps": steps,
           "epochs": int(payload.get("epochs", 0))}
    if "generator2_type" in config and payload["model"].get("generator2"):
        out["model"]["generator2"] = (generator_state_dict(
            payload, "generator2",
            fix_generator_params(config["generator2_params"]),
            config["generator2_type"]),)
    disc_type = config.get("discriminator_type")
    if disc_type in EXPORTED_DISCRIMINATORS and \
            payload["model"].get("discriminator"):
        out["model"]["discriminator"] = discriminator_state_dict(
            payload, disc_type, config.get("discriminator_params", {}))
    return out


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--to-torch", action="store_true",
                        help="export a JAX checkpoint as a reference-format "
                             "torch pickle")
    args = parser.parse_args(argv)
    if not args.to_torch:
        raise NotImplementedError(
            "a reference torch pickle to a JAX msgpack checkpoint is not "
            "ported (ROADMAP A11); the port loads reference pickles as they "
            "are, and the JAX package's convert_checkpoint writes msgpack")
    if args.config is None:
        args.config = os.path.join(os.path.dirname(args.checkpoint),
                                   "config.yml")
    out = export_checkpoint(load_checkpoint(args.checkpoint),
                            load_config(args.config))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    torch.save(out, args.out)
    n = sum(int(v.numel()) for v in out["model"]["generator"].values())
    print(f"exported generator ({n:,} params) as torch pickle -> {args.out}")


if __name__ == "__main__":
    main()
