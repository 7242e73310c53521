"""Feature datasets for decoding (port of the decode-side datasets of
``articulatory_tpu/data/datasets.py``): ``ArtDataset`` over a dump directory
or a feats.scp of .npy paths, and ``MelSCPDataset`` / ``ArtSCPDataset`` over
a feats.scp of hdf5 or npy values. They return numpy arrays."""

from __future__ import annotations

import logging
import os

import numpy as np

from articulatory_tpu_torch.utils.io import (
    HDF5ScpLoader,
    NpyScpLoader,
    find_files,
    load_scp,
)


class ArtDataset:
    """Articulatory (or any frame-rate) features from a dump directory
    (files matching ``query``; ``<utt>-feats.npy`` names give ``<utt>``) or a
    feats.scp of file paths."""

    def __init__(self, feats_scp_or_dir: str, query: str = "*.npy",
                 length_threshold: int | None = None,
                 return_utt_id: bool = False, allow_cache: bool = False,
                 transform=None, load_fn=None):
        self.load_fn = load_fn if load_fn is not None else np.load
        if os.path.isdir(feats_scp_or_dir):
            files = find_files(feats_scp_or_dir, query)
            self.utt_ids = [
                os.path.basename(f).replace("-feats.npy", "")
                if f.endswith("-feats.npy")
                else os.path.splitext(os.path.basename(f))[0]
                for f in files]
            self.art_files = files
        else:
            scp = load_scp(feats_scp_or_dir)
            self.utt_ids = list(scp.keys())
            self.art_files = list(scp.values())
        if length_threshold is not None:
            keep = [i for i, f in enumerate(self.art_files)
                    if self.load_fn(f).shape[0] > length_threshold]
            self.utt_ids = [self.utt_ids[i] for i in keep]
            self.art_files = [self.art_files[i] for i in keep]
        self.return_utt_id = return_utt_id
        self.transform = transform
        self.allow_cache = allow_cache
        self.caches: dict[int, object] = {}

    def __getitem__(self, idx: int):
        if self.allow_cache and idx in self.caches:
            return self.caches[idx]
        art = self.load_fn(self.art_files[idx])
        if self.transform is not None:
            art = self.transform(art)
        items = (self.utt_ids[idx], art) if self.return_utt_id else art
        if self.allow_cache:
            self.caches[idx] = items
        return items

    def __len__(self) -> int:
        return len(self.art_files)


class MelSCPDataset:
    """feats.scp-driven feature dataset (hdf5 or npy values)."""

    def __init__(self, feats_scp: str, mel_length_threshold=None,
                 return_utt_id: bool = False, allow_cache: bool = False):
        with open(feats_scp) as f:
            first = f.readline().split()
        value = first[1] if len(first) > 1 else ""
        self.loader = (NpyScpLoader(feats_scp) if value.endswith(".npy")
                       else HDF5ScpLoader(feats_scp))
        self.utt_ids = list(self.loader.keys())
        if mel_length_threshold is not None:
            keep = [u for u in self.utt_ids
                    if self.loader[u].shape[0] > mel_length_threshold]
            if len(keep) != len(self.utt_ids):
                logging.warning(
                    f"Some files are filtered by mel length threshold "
                    f"({len(self.utt_ids)} -> {len(keep)}).")
            self.utt_ids = keep
        self.return_utt_id = return_utt_id
        self.allow_cache = allow_cache
        self.caches: dict[int, object] = {}

    def __getitem__(self, idx: int):
        if self.allow_cache and idx in self.caches:
            return self.caches[idx]
        utt_id = self.utt_ids[idx]
        mel = self.loader[utt_id]
        items = (utt_id, mel) if self.return_utt_id else mel
        if self.allow_cache:
            self.caches[idx] = items
        return items

    def __len__(self) -> int:
        return len(self.utt_ids)


class ArtSCPDataset(MelSCPDataset):
    """``MelSCPDataset`` with an optional transform (reference
    scp_dataset.py:274)."""

    def __init__(self, feats_scp: str, transform=None, **kwargs):
        super().__init__(feats_scp, **kwargs)
        self.transform = transform

    def __getitem__(self, idx: int):
        items = super().__getitem__(idx)
        if self.transform is not None:
            if self.return_utt_id:
                items = (items[0], self.transform(items[1]))
            else:
                items = self.transform(items)
        return items
