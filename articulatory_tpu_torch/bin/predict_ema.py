#!/usr/bin/env python3
"""Speech-to-EMA inversion of a directory of wavs (port of
``egs/ema/voc1/local/predict_ema.py``).

Each ``<fid>.wav`` becomes input features, then, through the experiment's
inversion model (``<exp>/best_mel_ckpt.pkl`` and ``config.yml``),
``<fid>.npy`` EMA trajectories: the chunked AR loop for an AR model
(``--ar-scan``: through the captured chunk step; ``--batch N``: N wavs as
parallel AR lanes), one forward otherwise. The features:

- HuBERT (``_h2`` in the experiment id): the last hidden states of
  ``facebook/hubert-large-ll60k`` (``ARTICULATORY_HUBERT_MODEL`` names
  another model id or a local ``save_pretrained`` directory; the model is
  loaded once and cached), linearly interpolated (``align_corners=False``)
  by 2 for ``hprc*`` experiments, else by 4, to the EMA frame rate. The
  HuBERT forward (``hubert_states``, which needs the ``transformers``
  package and raises an ``ImportError`` without it) is kept apart from the
  interpolation (``interpolate_states``), which needs only torch;
- otherwise 13 z-scored MFCCs a frame (n_fft 320, 40 mels, hop 80, or 160
  for ``hprc*`` experiments).

    python -m articulatory_tpu_torch.bin.predict_ema <exp_id or exp_dir> \\
        <input_wav_dir> <output_dir> [--ar-scan] [--batch N] [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.nn.functional as F
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


def interp_factor_of(exp_id: str) -> int:
    """The HuBERT frame-rate factor: 2 for ``hprc*`` ids, else 4."""
    return 2 if os.path.basename(exp_id).startswith("hprc") else 4


_HUBERT = None


def load_hubert(device: str | torch.device = "cpu"):
    """The HuBERT model on ``device``, loaded once and cached;
    ``ARTICULATORY_HUBERT_MODEL`` overrides the model id."""
    global _HUBERT
    if _HUBERT is None:
        try:
            from transformers import HubertModel
        except ImportError as e:
            raise ImportError(
                "HuBERT features ('_h2' experiments) need the transformers "
                "package, which is not installed") from e
        name = os.environ.get("ARTICULATORY_HUBERT_MODEL",
                              "facebook/hubert-large-ll60k")
        _HUBERT = HubertModel.from_pretrained(name).eval()
    return _HUBERT.to(device)


def hubert_states(audio: np.ndarray, device: str | torch.device = "cpu"
                  ) -> torch.Tensor:
    """HuBERT's ``last_hidden_state`` of a wave, ``(1, frames, hidden)``
    on ``device``."""
    model = load_hubert(device)
    with torch.no_grad():
        wave = torch.from_numpy(np.asarray(audio, np.float32))[None]
        return model(wave.to(device)).last_hidden_state


def interpolate_states(states: torch.Tensor, interp_factor: int
                       ) -> torch.Tensor:
    """``(1, T, C)`` hidden states -> ``(T * interp_factor, C)``, linear,
    ``align_corners=False`` (the reference's ``F.interpolate``)."""
    return F.interpolate(states.transpose(1, 2),
                         size=states.shape[1] * interp_factor, mode="linear",
                         align_corners=False).transpose(1, 2)[0]


def hubert_features(audio: np.ndarray, interp_factor: int,
                    device: str | torch.device = "cpu") -> np.ndarray:
    """HuBERT features of a wave at the EMA frame rate, ``(T, hidden)``."""
    states = hubert_states(audio, device)
    return interpolate_states(states, interp_factor).float().cpu().numpy()


def predict(exp_id: str, wav_dir: str, out_dir: str, ar_scan: bool = False,
            batch: int = 1, device: str | None = None) -> list[str]:
    """Invert every ``*.wav`` of ``wav_dir`` into ``out_dir/<fid>.npy``;
    returns the fids written."""
    hubert = "_h2" in exp_id
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
        if hubert:
            return hubert_features(audio, interp_factor_of(exp_id),
                                   model.device).astype(np.float32)
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
