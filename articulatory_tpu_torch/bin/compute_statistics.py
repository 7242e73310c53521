#!/usr/bin/env python3
"""Mean and scale of the dumped features (port of
``articulatory_tpu/bin/compute_statistics.py``).

The features of ``--rootdir`` (``*.h5`` "feats" or ``*-feats.npy`` by the
config's ``format``) or of ``--feats-scp`` are accumulated utterance by
utterance, as scikit-learn's ``StandardScaler.partial_fit`` does
(``StandardScaler`` below), and written as ``<dumpdir>/stats.h5`` ("mean",
"scale") or ``<dumpdir>/stats.npy`` (``[mean; scale]``), float32.

    python -m articulatory_tpu_torch.bin.compute_statistics \\
        --rootdir dump/tr/raw --dumpdir dump/tr --config conf/x.yaml
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from articulatory_tpu_torch.bin.preprocess import load_yaml, set_logging
from articulatory_tpu_torch.data.datasets import FileDataset, MelSCPDataset
from articulatory_tpu_torch.utils.io import read_hdf5, write_hdf5


class StandardScaler:
    """Per-feature mean and standard deviation over batches of rows, with
    scikit-learn's ``StandardScaler.partial_fit`` arithmetic: each batch's
    float64 sum and corrected two-pass sum of squares are merged into the
    running ones by Chan, Golub and LeVeque's update; the variance is the
    biased one; NaNs are left out. A feature whose variance is within the
    two-pass algorithm's error bound of zero, ``var <= n * eps * var + (n *
    mean * eps) ** 2``, counts as constant and gets scale 1."""

    def __init__(self):
        self.n_samples_seen_ = None
        self.mean_ = self.var_ = self.scale_ = None

    def partial_fit(self, x: np.ndarray) -> "StandardScaler":
        x = np.asarray(x)
        if x.dtype not in (np.float32, np.float64):
            x = x.astype(np.float64)
        nan = np.isnan(x)
        total = np.nansum if nan.any() else np.sum
        if self.n_samples_seen_ is None:
            last_count = np.zeros(x.shape[1], np.float64)
            last_mean = last_var = 0.0
        else:
            last_count = np.broadcast_to(self.n_samples_seen_, x.shape[1]
                                         ).astype(np.float64)
            last_mean, last_var = self.mean_, self.var_
        last_sum = last_mean * last_count
        new_sum = total(x, axis=0, dtype=np.float64)
        new_count = x.shape[0] - total(nan.astype(x.dtype), axis=0,
                                       dtype=np.float64)
        count = last_count + new_count
        mean = (last_sum + new_sum) / count
        temp = x - new_sum / new_count
        correction = total(temp, axis=0, dtype=np.float64)
        temp **= 2
        new_unnormalized = total(temp, axis=0, dtype=np.float64)
        new_unnormalized -= correction ** 2 / new_count
        with np.errstate(divide="ignore", invalid="ignore"):
            last_over_new = last_count / new_count
            unnormalized = (last_var * last_count + new_unnormalized
                            + last_over_new / count
                            * (last_sum / last_over_new - new_sum) ** 2)
        first = last_count == 0
        unnormalized[first] = new_unnormalized[first]
        self.mean_, self.var_ = mean, unnormalized / count
        # one count for all features while no feature has a NaN
        self.n_samples_seen_ = count[0] if count.max() == count.min() else count
        eps = np.finfo(np.float64).eps
        n = self.n_samples_seen_
        constant = self.var_ <= (n * eps * self.var_
                                 + (n * self.mean_ * eps) ** 2)
        self.scale_ = np.sqrt(self.var_)
        self.scale_[constant] = 1.0
        return self


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="Compute mean and variance of dumped raw features.")
    parser.add_argument("--feats-scp", "--scp", default=None, type=str)
    parser.add_argument("--rootdir", type=str, default=None)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--dumpdir", type=str, required=True)
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    set_logging(args.verbose)
    config = load_yaml(args.config)
    config.update(vars(args))
    if (args.feats_scp is not None) == (args.rootdir is not None):
        raise ValueError("Please specify either --rootdir or --feats-scp.")
    if args.feats_scp is not None:
        dataset = MelSCPDataset(args.feats_scp)
    elif config["format"] == "hdf5":
        dataset = FileDataset(args.rootdir, "*.h5",
                              lambda p: read_hdf5(p, "feats"))
    elif config["format"] == "npy":
        dataset = FileDataset(args.rootdir, "*-feats.npy", np.load)
    else:
        raise ValueError("support only hdf5 or npy format.")
    logging.info(f"The number of files = {len(dataset)}.")
    scaler = StandardScaler()
    for i in range(len(dataset)):
        scaler.partial_fit(dataset[i])
    os.makedirs(args.dumpdir, exist_ok=True)
    mean = scaler.mean_.astype(np.float32)
    scale = scaler.scale_.astype(np.float32)
    if config["format"] == "hdf5":
        path = os.path.join(args.dumpdir, "stats.h5")
        write_hdf5(path, "mean", mean)
        write_hdf5(path, "scale", scale)
    else:
        np.save(os.path.join(args.dumpdir, "stats.npy"),
                np.stack([mean, scale]), allow_pickle=False)


if __name__ == "__main__":
    main()
