#!/usr/bin/env python3
"""Predict waveforms from articulatory features, the recipes' public
synthesis API (port of ``egs/ema/voc1/local/predict_wav.py``, which
``egs/mri/voc1/local/predict_wav.py`` repeats).

Reads a feats.scp of ``.npy`` features, loads the trained generator (a JAX
msgpack checkpoint or a reference torch pickle; the config beside it
unless ``--config``), prints its parameter count, freezes its kernels (as
``bin/decode.py`` does; the outputs do not change) and writes
``<outdir>/<fid>.wav`` per utterance: the chunked AR loop (``ar_loop``)
for an AR generator, the full-utterance forward (``LoadedModel.inference``)
otherwise. Utterances of 250 frames or fewer are skipped, as in the
reference. Runs on the card unless ``--device cpu``.

    python -m articulatory_tpu_torch.bin.predict_wav --feats-scp feats.scp \\
        --checkpoint exp/x/best_mel_ckpt.pkl --outdir out [--config conf.yml]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from articulatory_tpu_torch.config import load_config
from articulatory_tpu_torch.inference import ar_loop, load_model
from articulatory_tpu_torch.utils.io import load_scp, write_wav

MIN_FRAMES = 250  # utterances this short or shorter are skipped


def predict_wav(feats_scp: str, outdir: str, checkpoint: str,
                config: dict, device: str | None = None) -> list[str]:
    """Decode every utterance of ``feats_scp`` longer than MIN_FRAMES into
    ``outdir/<fid>.wav``; returns the fids written."""
    os.makedirs(outdir, exist_ok=True)
    model = load_model(checkpoint, config, device=device)
    logging.info(f"Loaded model parameters from {checkpoint}.")
    print(sum(p.numel() for p in model.model.parameters()))
    model.remove_weight_norm()  # frozen kernels; outputs are unchanged
    use_ar = config["generator_params"].get("use_ar", False)
    written = []
    for fid, path in load_scp(feats_scp).items():
        c = np.load(path)
        if c.shape[0] <= MIN_FRAMES:
            continue
        y = ar_loop(model, c, config) if use_ar else \
            model.inference(c).squeeze()
        write_wav(os.path.join(outdir, fid + ".wav"), np.asarray(y),
                  config["sampling_rate"])
        written.append(fid)
    return written


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Predict wav from features.")
    parser.add_argument("--feats-scp", "--scp", type=str, required=True)
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--config", default=None, type=str)
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) or cpu")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARN)
    if args.config is None:
        args.config = os.path.join(os.path.dirname(args.checkpoint),
                                   "config.yml")
    config = load_config(args.config)
    config.update(vars(args))
    predict_wav(args.feats_scp, args.outdir, args.checkpoint, config,
                device=args.device)


if __name__ == "__main__":
    main()
