#!/usr/bin/env python3
"""Speech-to-EMA inversion of a directory of wavs (port of the MFCC path of
``egs/ema/voc1/local/predict_ema.py``).

Each ``<fid>.wav`` becomes 13 z-scored MFCCs a frame (n_fft 320, 40 mels,
hop 80, or 160 for ``hprc*`` experiments) and then, through the
experiment's ``BiGRU`` (``<exp>/best_mel_ckpt.pkl`` and ``config.yml``),
``<fid>.npy`` EMA trajectories: the chunked AR loop for an AR model
(``--ar-scan``: through the captured chunk step; ``--batch N``: N wavs as
parallel AR lanes), one forward otherwise. HuBERT-feature experiments
(``_h2`` in the id) raise: they need the ``transformers`` package and the
``facebook/hubert-large-ll60k`` weights, which the port does not have.

    python -m articulatory_tpu_torch.bin.predict_ema <exp_id or exp_dir> \\
        <input_wav_dir> <output_dir> [--ar-scan] [--batch N] [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np
from scipy import stats

from articulatory_tpu_torch.inference import (
    ar_loop,
    ar_loop_batched,
    ar_loop_scan,
    load_model,
)
from articulatory_tpu_torch.ops.mfcc import mfcc_np
from articulatory_tpu_torch.utils.io import read_wav


def wav2mfcc(wav: np.ndarray, sr: int, num_mfcc: int = 13, n_mels: int = 40,
             n_fft: int = 320, hop_length: int = 160) -> np.ndarray:
    """MFCCs ``(num_mfcc, frames)``, z-scored over the whole array."""
    feat = mfcc_np(wav, sr, n_mfcc=num_mfcc, n_fft=n_fft,
                   hop_length=hop_length, n_mels=n_mels)
    return stats.zscore(feat, axis=None)


def hop_of(exp_id: str) -> int:
    """The MFCC hop of an experiment: 160 for ``hprc*`` ids (x2 feature
    interpolation in the reference), else 80 (x4)."""
    return 160 if os.path.basename(exp_id).startswith("hprc") else 80


def predict(exp_id: str, wav_dir: str, out_dir: str, ar_scan: bool = False,
            batch: int = 1, device: str | None = None) -> list[str]:
    """Invert every ``*.wav`` of ``wav_dir`` into ``out_dir/<fid>.npy``;
    returns the fids written."""
    if "_h2" in exp_id:
        raise NotImplementedError(
            "HuBERT features ('_h2' experiments) are not ported: they need "
            "the transformers package and the facebook/hubert-large-ll60k "
            "weights in the repository")
    hop_length = hop_of(exp_id)
    exp_dir = exp_id if os.path.isdir(exp_id) else os.path.join("exp", exp_id)
    from articulatory_tpu_torch.config import load_config

    config = load_config(os.path.join(exp_dir, "config.yml"))
    model = load_model(os.path.join(exp_dir, "best_mel_ckpt.pkl"), config,
                       device=device)
    files = sorted(f for f in os.listdir(wav_dir) if f.endswith(".wav"))
    os.makedirs(out_dir, exist_ok=True)

    def featurize(name: str) -> np.ndarray:
        audio, sr = read_wav(os.path.join(wav_dir, name))
        return wav2mfcc(audio, sr, hop_length=hop_length).T.astype(np.float32)

    def save(name: str, pred: np.ndarray) -> None:
        np.save(os.path.join(out_dir, name[: name.rfind(".")] + ".npy"),
                np.asarray(pred))

    use_ar = config["generator_params"].get("use_ar", False)
    if batch > 1 and use_ar:
        for i in range(0, len(files), batch):
            group = files[i:i + batch]
            preds = ar_loop_batched(model, [featurize(f) for f in group],
                                    config, scan=ar_scan)
            for name, pred in zip(group, preds):
                save(name, pred)
    else:
        for name in files:
            feat = featurize(name)
            if not use_ar:
                pred = model.inference(feat)
            elif ar_scan:
                pred = ar_loop_scan(model, feat, config)
            else:
                pred = ar_loop(model, feat, config)
            save(name, pred)
    return [f[: f.rfind(".")] for f in files]


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    usage = ("usage: predict_ema <exp_id or exp_dir> <input_wav_dir> "
             "<output_dir> [--ar-scan] [--batch N] [--device cuda|cpu]")
    if len(argv) < 3:
        sys.exit(usage)
    exp_id, wav_dir, out_dir = argv[:3]
    extra = argv[3:]
    ar_scan, batch, device = False, 1, "cuda"
    while extra:
        tok = extra.pop(0)
        if tok == "--ar-scan":
            ar_scan = True
        elif tok in ("--batch", "--device"):
            if not extra:
                sys.exit(f"predict_ema: {tok} requires a value")
            val = extra.pop(0)
            if tok == "--device":
                device = val
                continue
            try:
                batch = int(val)
            except ValueError:
                sys.exit(f"predict_ema: --batch expects an integer, got "
                         f"{val!r}")
            if batch < 1:
                sys.exit(f"predict_ema: --batch must be >= 1, got {batch}")
        else:
            sys.exit(f"predict_ema: unrecognized argument {tok!r} (known: "
                     f"--ar-scan, --batch N, --device D)")
    predict(exp_id, wav_dir, out_dir, ar_scan=ar_scan, batch=batch,
            device=device)


if __name__ == "__main__":
    main()
