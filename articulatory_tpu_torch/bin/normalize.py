#!/usr/bin/env python3
"""Z-score dumped features with precomputed statistics (port of
``articulatory_tpu/bin/normalize.py``): ``(feats - mean) / scale``, float32,
the wave copied through unless ``--skip-wav-copy``.

The inputs are a dump directory (``--rootdir``: ``*.h5`` or
``*-feats.npy`` / ``*-wave.npy`` by the config's ``format``), or
``--feats-scp`` with the waves from ``--wav-scp`` (and ``--segments``).
``--stats`` is ``stats.h5`` ("mean", "scale") or ``stats.npy``.

    python -m articulatory_tpu_torch.bin.normalize --rootdir dump/tr/raw \\
        --dumpdir dump/tr/norm --stats dump/tr/stats.h5 --config conf/x.yaml
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from articulatory_tpu_torch.bin.preprocess import (
    load_yaml,
    set_logging,
    write_dump,
)
from articulatory_tpu_torch.data.datasets import MelSCPDataset
from articulatory_tpu_torch.utils.io import WavScpLoader, find_files, read_hdf5


def _read_stats(path: str) -> tuple[np.ndarray, np.ndarray]:
    if path.endswith(".h5"):
        return read_hdf5(path, "mean"), read_hdf5(path, "scale")
    stats = np.load(path)
    return stats[0], stats[1]


def _dump_inputs(rootdir: str, fmt: str):
    """``(utt_id, load feats, load wave)`` of each utterance of a dump."""
    if fmt == "hdf5":
        for path in find_files(rootdir, "*.h5"):
            yield (os.path.splitext(os.path.basename(path))[0],
                   lambda p=path: read_hdf5(p, "feats"),
                   lambda p=path: read_hdf5(p, "wave"))
    elif fmt == "npy":
        for path in find_files(rootdir, "*-feats.npy"):
            yield (os.path.basename(path).replace("-feats.npy", ""),
                   lambda p=path: np.load(p),
                   lambda p=path: np.load(p.replace("-feats.npy",
                                                    "-wave.npy")))
    else:
        raise ValueError("support only hdf5 or npy format.")


def _scp_inputs(feats_scp: str, wav_scp: str | None, segments: str | None):
    dataset = MelSCPDataset(feats_scp, return_utt_id=True)
    waves = (WavScpLoader(wav_scp, segments=segments)
             if wav_scp is not None else None)
    for i in range(len(dataset)):
        utt_id = dataset.utt_ids[i]
        yield (utt_id, lambda i=i: dataset[i][1],
               lambda u=utt_id: waves[u][0])


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="Normalize dumped raw features.")
    parser.add_argument("--rootdir", type=str, default=None)
    parser.add_argument("--wav-scp", "--scp", default=None, type=str)
    parser.add_argument("--feats-scp", default=None, type=str)
    parser.add_argument("--segments", default=None, type=str)
    parser.add_argument("--dumpdir", type=str, required=True)
    parser.add_argument("--stats", type=str, required=True)
    parser.add_argument("--skip-wav-copy", default=False, action="store_true")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    set_logging(args.verbose)
    config = load_yaml(args.config)
    config.update(vars(args))
    mean, scale = _read_stats(args.stats)
    os.makedirs(args.dumpdir, exist_ok=True)
    if (args.feats_scp is not None) == (args.rootdir is not None):
        raise ValueError("Please specify either --rootdir or --feats-scp.")
    if args.feats_scp is not None:
        if args.wav_scp is None and not args.skip_wav_copy:
            raise ValueError("--wav-scp required unless --skip-wav-copy")
        inputs = _scp_inputs(args.feats_scp, args.wav_scp, args.segments)
    else:
        inputs = _dump_inputs(args.rootdir, config["format"])
    for utt_id, feats, wave in inputs:
        arrays = {"feats": (feats() - mean) / scale}
        if not args.skip_wav_copy:
            arrays["wave"] = wave()
        write_dump(args.dumpdir, utt_id, config["format"], **arrays)


if __name__ == "__main__":
    main()
