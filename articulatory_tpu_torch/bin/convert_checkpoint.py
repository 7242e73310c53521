#!/usr/bin/env python3
"""Convert checkpoints between the reference (PyTorch) and the JAX package
(port of ``articulatory_tpu/bin/convert_checkpoint.py``).

Default: a reference torch pickle (``checkpoint-XXXsteps.pkl``,
``best_mel_ckpt.pkl``, or one the port wrote) becomes a JAX msgpack
checkpoint that the JAX package's ``load_model`` and ``--pretrain`` read,
and so does the port's: ``{"model": {"generator"[, "discriminator"]},
"optimizer": {}, "mutables": {"generator": batch_stats}, "scheduler": {},
"steps", "epochs"}``, the generator through ``utils/weights.py::
GENERATOR_TO_JAX`` and the discriminator, where its type has a converter,
through ``DISCRIMINATOR_TO_JAX``; a discriminator whose layout does not
match is logged and left out. The file is written as flax's
``msgpack_serialize`` writes it (``utils/checkpoint.py::save_msgpack``).

``--to-torch``: a JAX msgpack checkpoint becomes a reference-format torch
pickle through the port's own converters (``utils/weights.py``), in the
layout of the JAX package's ``utils/torch_export.py::export_checkpoint``:
``{"model": {"generator"[, "generator2"][, "discriminator"]},
"optimizer": {}, "scheduler": {}, "steps", "epochs"}`` with the
``weight_g`` / ``weight_v`` reparam; a cascade's ``generator2`` as a
1-tuple (the reference's save quirk), the discriminator for the types the
JAX package exports. The reference's ``load_model`` and ``--pretrain``
read it, and so does the port's.

    python -m articulatory_tpu_torch.bin.convert_checkpoint \\
        --checkpoint ref/best_mel_ckpt.pkl --config ref/config.yml \\
        --out exp/converted/best_mel_ckpt.pkl
    python -m articulatory_tpu_torch.bin.convert_checkpoint --to-torch \\
        --checkpoint exp/ours/best_mel_ckpt.pkl --out export/ckpt.pkl
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from articulatory_tpu_torch.config import fix_generator_params, load_config
from articulatory_tpu_torch.utils.checkpoint import (
    discriminator_state_dict,
    generator_state_dict,
    load_checkpoint,
    save_msgpack,
)
from articulatory_tpu_torch.utils.weights import (
    DISCRIMINATOR_TO_JAX,
    GENERATOR_TO_JAX,
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


def import_checkpoint(payload: dict, config: dict) -> dict:
    """A reference torch-pickle payload -> the JAX package's checkpoint
    payload."""
    gen_type = config.get("generator_type", "ParallelWaveGANGenerator")
    if gen_type not in GENERATOR_TO_JAX:
        raise NotImplementedError(f"no importer for generator {gen_type}")
    params_g, mutables_g = GENERATOR_TO_JAX[gen_type](
        payload["model"]["generator"],
        fix_generator_params(config["generator_params"]))
    out = {"model": {"generator": params_g}, "optimizer": {},
           "mutables": {"generator": (mutables_g or {}).get("batch_stats",
                                                            {})},
           "scheduler": {}, "steps": int(payload.get("steps", 0)),
           "epochs": int(payload.get("epochs", 0))}
    disc_type = config.get("discriminator_type")
    if "discriminator" in payload["model"] and \
            disc_type in DISCRIMINATOR_TO_JAX:
        try:
            out["model"]["discriminator"] = DISCRIMINATOR_TO_JAX[disc_type](
                payload["model"]["discriminator"],
                config.get("discriminator_params", {}))
        except KeyError as e:
            logging.warning(
                f"discriminator NOT converted (layout mismatch on key {e}); "
                f"the output checkpoint has no discriminator: training "
                f"resumed from it initialises the discriminator anew")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--to-torch", action="store_true",
                        help="export a JAX checkpoint as a reference-format "
                             "torch pickle")
    args = parser.parse_args(argv)
    if args.config is None:
        args.config = os.path.join(os.path.dirname(args.checkpoint),
                                   "config.yml")
    config = load_config(args.config)
    if not args.to_torch:
        out = import_checkpoint(load_checkpoint(args.checkpoint), config)
        save_msgpack(args.out, out)
        n = sum(int(v.size) for v in _leaves(out["model"]["generator"]))
        print(f"converted generator ({n:,} params) -> {args.out}")
        return
    out = export_checkpoint(load_checkpoint(args.checkpoint), config)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    torch.save(out, args.out)
    n = sum(int(v.numel()) for v in out["model"]["generator"].values())
    print(f"exported generator ({n:,} params) as torch pickle -> {args.out}")


if __name__ == "__main__":
    main()
