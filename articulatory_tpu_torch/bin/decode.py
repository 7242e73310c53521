#!/usr/bin/env python3
"""Decode dumped features with a trained generator on the GPU (port of
``articulatory_tpu/bin/decode.py`` for the a2w and default dataset modes).

Writes ``<utt>_gen.wav`` per utterance and logs the real-time factor. AR
generators decode chunk by chunk (``ar_loop``), or ``--decode-batch-size``
utterances at a time (``ar_loop_batched``); others in one forward.

    python -m articulatory_tpu_torch.bin.decode --device cuda \\
        --dumpdir dump/eval/norm --checkpoint exp/x/ckpt.pkl --outdir out
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np

from articulatory_tpu_torch.data.datasets import ArtDataset, ArtSCPDataset, MelSCPDataset
from articulatory_tpu_torch.inference import ar_loop, ar_loop_batched, load_model
from articulatory_tpu_torch.utils.io import read_hdf5, write_wav

_NOT_PORTED = ("int8_weights", "bf16_weights", "ar_scan")


def _dataset(config: dict, dumpdir: str | None, feats_scp: str | None):
    if (feats_scp is not None) == (dumpdir is not None):
        raise ValueError("Please specify either --dumpdir or --feats-scp.")
    mode = config.get("dataset_mode", "default")
    if config.get("transform") or config.get("input_transform"):
        raise NotImplementedError("input transforms are not ported yet")
    if mode not in ("default", "m2w", "a2w", "art"):
        raise NotImplementedError(f"dataset_mode {mode!r} is not ported yet")
    if feats_scp is not None:
        cls = MelSCPDataset if mode in ("default", "m2w") else ArtSCPDataset
        return cls(feats_scp, return_utt_id=True)
    if config.get("format", "hdf5") == "hdf5":
        return ArtDataset(dumpdir, query="*.h5", return_utt_id=True,
                          load_fn=lambda path: read_hdf5(path, "feats"))
    return ArtDataset(dumpdir, query="*-feats.npy", return_utt_id=True)


def decode(config: dict, checkpoint: str, outdir: str, *,
           dumpdir: str | None = None, feats_scp: str | None = None,
           decode_batch_size: int = 1, normalize_before: bool = False,
           bucket_frames: int = 64, device=None) -> dict:
    """Decode every utterance of a dump directory or feats.scp into
    ``outdir/<utt>_gen.wav``. Returns ``{"utterances", "seconds_audio",
    "seconds_elapsed"}``."""
    dataset = _dataset(config, dumpdir, feats_scp)
    logging.info(f"The number of features to be decoded = {len(dataset)}.")
    model = load_model(checkpoint, config, device=device)
    logging.info(f"Loaded model parameters from {checkpoint}.")
    model.remove_weight_norm()
    os.makedirs(outdir, exist_ok=True)
    use_ar = config["generator_params"].get("use_ar", False)
    sr = config["sampling_rate"]
    items = [(utt_id, np.asarray(c, np.float32)) for utt_id, c in dataset]
    total_time = total_len = 0.0
    if use_ar and decode_batch_size > 1:
        groups = [items[i:i + decode_batch_size]
                  for i in range(0, len(items), decode_batch_size)]
    else:
        groups = [[item] for item in items]
    for group in groups:
        start = time.perf_counter()
        if use_ar and decode_batch_size > 1:
            outs = ar_loop_batched(model, [c for _, c in group], config)
        elif use_ar:
            outs = [ar_loop(model, group[0][1], config)]
        else:
            outs = [model.inference(group[0][1],
                                    normalize_before=normalize_before,
                                    bucket_frames=bucket_frames or None
                                    ).reshape(-1)]
        total_time += time.perf_counter() - start
        for (utt_id, _), wav in zip(group, outs):
            write_wav(os.path.join(outdir, f"{utt_id}_gen.wav"), wav, sr)
            total_len += len(wav) / sr
    logging.info(f"Finished generation of {len(items)} utterances; "
                 f"throughput = {total_len / max(total_time, 1e-9):.1f}x "
                 f"realtime (RTF {total_time / max(total_len, 1e-9):.6f}).")
    return {"utterances": len(items), "seconds_audio": total_len,
            "seconds_elapsed": total_time}


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="Decode dumped features with a trained generator.")
    parser.add_argument("--feats-scp", "--scp", default=None, type=str)
    parser.add_argument("--dumpdir", default=None, type=str)
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--config", default=None, type=str)
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--normalize-before", default=False, action="store_true")
    parser.add_argument("--bucket-frames", default=64, type=int,
                        help="pad full-utterance inference lengths to this "
                             "multiple (0 = exact)")
    parser.add_argument("--decode-batch-size", default=1, type=int,
                        help="batch N utterances through the AR loop "
                             "(1 = reference-exact sequential decode)")
    for flag in _NOT_PORTED:
        parser.add_argument("--" + flag.replace("_", "-"), default=False,
                            action="store_true", help="not ported yet (raises)")
    parser.add_argument("--sequence-parallel", default=0, type=int,
                        help="not ported yet (raises for N > 1)")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose > 1 else
        logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s")
    asked = [flag for flag in _NOT_PORTED if getattr(args, flag)]
    if args.sequence_parallel > 1:
        asked.append("sequence_parallel")
    if asked:
        parser.error(", ".join("--" + f.replace("_", "-") for f in asked)
                     + " is not yet ported to articulatory_tpu_torch")

    from articulatory_tpu_torch.config import load_config

    config = load_config(args.config or os.path.join(
        os.path.dirname(args.checkpoint), "config.yml"))
    config.update(vars(args))
    decode(config, args.checkpoint, args.outdir, dumpdir=args.dumpdir,
           feats_scp=args.feats_scp, decode_batch_size=args.decode_batch_size,
           normalize_before=args.normalize_before,
           bucket_frames=args.bucket_frames, device=args.device)


if __name__ == "__main__":
    main()
