#!/usr/bin/env python3
"""Dump each utterance's wave and log-mel features (port of
``articulatory_tpu/bin/preprocess.py``, host numpy only).

Input is a wav.scp (``--wav-scp``, with optional ``--segments``) or the
``*.wav`` files under ``--rootdir``. Each wave is trimmed of silence
(``trim_silence``), its features taken at ``sampling_rate_for_feats``
where the config sets one (the wave resampled for them), the wave padded
(reflect) and cut to ``len(mel) * hop_size`` samples and scaled by
``global_gain_scale``; an utterance that then clips (``|x| >= 1``) is
skipped with a warning. ``format: hdf5`` writes ``<utt>.h5`` ("wave",
"feats"), ``format: npy`` ``<utt>-wave.npy`` and ``<utt>-feats.npy``.

    python -m articulatory_tpu_torch.bin.preprocess --wav-scp data/tr/wav.scp \\
        --dumpdir dump/tr/raw --config conf/e2w_hifigan_car.yaml
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from articulatory_tpu_torch.data.datasets import AudioSCPDataset, FileDataset
from articulatory_tpu_torch.ops.audio import resample, trim_silence
from articulatory_tpu_torch.ops.mel import logmelfilterbank_np
from articulatory_tpu_torch.utils.io import read_wav, write_hdf5


def set_logging(verbose: int) -> None:
    logging.basicConfig(
        level=logging.DEBUG if verbose > 1 else
        logging.INFO if verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s")


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.load(f, Loader=yaml.Loader)


def write_dump(dumpdir: str, utt_id: str, fmt: str, **arrays) -> None:
    """``arrays`` (name -> array, as float32) of one utterance: datasets of
    ``<utt>.h5`` (hdf5), or ``<utt>-<name>.npy`` files (npy)."""
    for name, array in arrays.items():
        array = np.asarray(array).astype(np.float32)
        if fmt == "hdf5":
            write_hdf5(os.path.join(dumpdir, f"{utt_id}.h5"), name, array)
        elif fmt == "npy":
            np.save(os.path.join(dumpdir, f"{utt_id}-{name}.npy"), array,
                    allow_pickle=False)
        else:
            raise ValueError("support only hdf5 or npy format.")


def features(audio: np.ndarray, fs: int, config: dict
             ) -> tuple[np.ndarray, np.ndarray] | None:
    """``(wave, log-mel)`` of one utterance as the module docstring says,
    or None where the scaled wave clips."""
    if config.get("trim_silence", False):
        audio, _ = trim_silence(audio, top_db=config["trim_threshold_in_db"],
                                frame_length=config["trim_frame_size"],
                                hop_length=config["trim_hop_size"])
    hop = config["hop_size"]
    if "sampling_rate_for_feats" not in config:
        x, sampling_rate, feat_hop = audio, config["sampling_rate"], hop
    else:
        sampling_rate = config["sampling_rate_for_feats"]
        if hop * sampling_rate % fs:
            raise ValueError(f"hop_size {hop} at {fs} Hz is no whole hop at "
                             f"{sampling_rate} Hz")
        x = resample(audio, fs, sampling_rate)
        feat_hop = hop * sampling_rate // fs
    mel = logmelfilterbank_np(
        x, sampling_rate, fft_size=config["fft_size"], hop_size=feat_hop,
        win_length=config["win_length"], window=config["window"],
        num_mels=config["num_mels"], fmin=config["fmin"], fmax=config["fmax"],
        log_base=config.get("log_base", 10.0))
    audio = np.pad(audio, (0, config["fft_size"]), mode="reflect")
    audio = audio[: len(mel) * hop]
    if config.get("global_gain_scale", 1.0) > 0.0:
        audio = audio * config["global_gain_scale"]
    if np.abs(audio).max() >= 1.0:
        return None
    return audio, mel


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="Preprocess audio and then extract features.")
    parser.add_argument("--wav-scp", "--scp", default=None, type=str)
    parser.add_argument("--segments", default=None, type=str)
    parser.add_argument("--rootdir", default=None, type=str)
    parser.add_argument("--dumpdir", type=str, required=True)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    set_logging(args.verbose)
    config = load_yaml(args.config)
    config.update(vars(args))
    if (args.wav_scp is not None) == (args.rootdir is not None):
        raise ValueError("Please specify either --rootdir or --wav-scp.")
    if args.rootdir is not None:
        dataset = FileDataset(args.rootdir, "*.wav", read_wav,
                              return_utt_id=True)
    else:
        dataset = AudioSCPDataset(args.wav_scp, segments=args.segments,
                                  return_utt_id=True)
    os.makedirs(args.dumpdir, exist_ok=True)
    written = 0
    for i in range(len(dataset)):
        item = dataset[i]
        utt_id, (audio, fs) = item[0], (item[1] if len(item) == 2
                                        else item[1:])
        if audio.ndim != 1:
            raise ValueError(f"{utt_id} seems to be multi-channel signal.")
        if np.abs(audio).max() > 1.0:
            raise ValueError(f"{utt_id} seems to be different from 16 bit "
                             f"PCM.")
        if fs != config["sampling_rate"]:
            raise ValueError(f"{utt_id} seems to have a different sampling "
                             f"rate.")
        out = features(audio, fs, config)
        if out is None:
            logging.warning(f"{utt_id} causes clipping. it is better to "
                            f"re-consider global gain scale.")
            continue
        write_dump(args.dumpdir, utt_id, config["format"], wave=out[0],
                   feats=out[1])
        written += 1
    logging.info(f"wrote {written} of {len(dataset)} utterances to "
                 f"{args.dumpdir}")


if __name__ == "__main__":
    main()
