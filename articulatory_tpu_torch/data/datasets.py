"""Feature datasets (port of ``articulatory_tpu/data/datasets.py``):
``SpeechDataset`` for training (audio from a dump directory, articulatory
features through ``<data_root>/<stage>/feats.scp``, and speaker ids,
phoneme ids and mels where asked); for decoding
``ArtDataset`` over a dump directory or a feats.scp of .npy paths,
``MelSCPDataset`` / ``ArtSCPDataset`` over a feats.scp of hdf5 or npy
values, and ``AudioSCPDataset`` over a wav.scp (the w2a decode's input);
``MelArtDataset``, the (mel, art) pairs of a2m / m2a / art training;
``FileDataset``, the files of one query in a directory (the
preprocessing CLIs' inputs). ``mel_length_threshold`` keeps only the
utterances whose features have more frames than it (``bin/train.py``'s
``remove_short_samples``). They return numpy arrays."""

from __future__ import annotations

import logging
import os
from typing import Sequence

import numpy as np

from articulatory_tpu_torch.utils.io import (
    HDF5ScpLoader,
    NpyScpLoader,
    WavScpLoader,
    find_files,
    load_scp,
    read_hdf5,
)


def _stage_from_root(root_dir: str) -> str:
    """The data-stage name of a dump dir: the component after a 'dump'
    directory, else the 2nd component of a relative path, else the
    basename (the reference hard-codes ``root_dir.split('/')[1]``)."""
    parts = [p for p in os.path.normpath(root_dir).split(os.sep) if p]
    if "dump" in parts:
        i = parts.index("dump")
        if i + 1 < len(parts):
            return parts[i + 1]
    if not os.path.isabs(root_dir) and len(parts) > 1:
        return parts[1]
    return parts[-1]


def _utt_id(path: str) -> str:
    """``<utt>`` of ``<utt>-feats.npy``, ``<utt>-wave.npy`` or
    ``<utt>.<ext>``."""
    name = os.path.basename(path)
    for suffix in ("-feats.npy", "-wave.npy"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return os.path.splitext(name)[0]


def _read_wave(path: str) -> np.ndarray:
    return read_hdf5(path, "wave")


def _above(files: list, load_fn, threshold: int | None, what: str,
           *paired: list) -> tuple[list, ...]:
    """``files`` (and the lists ``paired`` with them) cut to the entries
    whose ``load_fn(file)`` has more than ``threshold`` rows."""
    if threshold is None:
        return (files, *paired)
    keep = [i for i, f in enumerate(files) if len(load_fn(f)) > threshold]
    if len(keep) != len(files):
        logging.warning(f"Some files are filtered by {what} length threshold "
                        f"({len(files)} -> {len(keep)}).")
    return tuple([xs[i] for i in keep] for xs in (files, *paired))


class SpeechDataset:
    """Training utterances ``{"art", "audio"}``: audio from the dump
    directory (``audio_query`` files through ``audio_load_fn``; the
    ``mel_query`` files must pair with them one to one), articulatory
    features (.npy) through ``<data_root>/<stage>/feats.scp``.
    ``input_transform`` (default ``transform``) maps the features,
    ``output_transform`` the audio (no default: ``bin/train.py`` decides
    it, as in the JAX package). With ``dataset_mode`` ph2m an item
    holds ``mel`` too (``mel_load_fn`` of the ``mel_query`` file, cut to the
    art's frames); with ``use_spk_id`` its ``spk_id``, the index of its
    speaker in ``spks`` (default: the sorted speakers of ``utt2spk`` /
    ``spk2utt`` under ``<data_root>/<stage>/``; a dev set takes the training
    set's); with ``use_ph`` its phoneme ids ``ph`` (.npy through
    ``<data_root>/<stage>/ph.scp``)."""

    def __init__(self, root_dir: str, audio_query: str = "*.h5",
                 mel_query: str = "*.h5", audio_load_fn=_read_wave,
                 mel_load_fn=None, mel_length_threshold: int | None = None,
                 allow_cache: bool = False, transform=None,
                 input_transform=None, output_transform=None,
                 spks: Sequence[str] | None = None, use_spk_id: bool = False,
                 use_ph: bool = False, dataset_mode: str | None = None,
                 data_root: str = "data"):
        audio_files = sorted(find_files(root_dir, audio_query))
        mel_files = sorted(find_files(root_dir, mel_query))
        if not audio_files:
            raise FileNotFoundError(f"Not found any audio files in {root_dir}.")
        if len(audio_files) != len(mel_files):
            raise ValueError(f"{root_dir}: {len(audio_files)} audio files but "
                             f"{len(mel_files)} feature files")
        self.mel_load_fn = mel_load_fn or (lambda p: read_hdf5(p, "feats"))
        mel_files, audio_files = _above(mel_files, self.mel_load_fn,
                                        mel_length_threshold, "mel",
                                        audio_files)
        if not audio_files:
            raise FileNotFoundError(f"no utterance of {root_dir} is longer "
                                    f"than {mel_length_threshold} frames")
        self.audio_files, self.mel_files = audio_files, mel_files
        self.audio_load_fn = audio_load_fn
        if ".npy" in audio_query:
            self.utt_ids = [os.path.basename(f).replace("-wave.npy", "")
                            for f in audio_files]
        else:
            self.utt_ids = [os.path.splitext(os.path.basename(f))[0]
                            for f in audio_files]
        stage_dir = os.path.join(data_root, _stage_from_root(root_dir))
        feats_path = os.path.join(stage_dir, "feats.scp")
        if not os.path.exists(feats_path):
            raise FileNotFoundError(f"missing {feats_path}")
        fid_to_artp = load_scp(feats_path)
        self.art_files = [fid_to_artp[fid] for fid in self.utt_ids]

        self.utt2spk, self.spk2utt = _speakers(stage_dir)
        if spks is None and self.spk2utt is not None:
            spks = sorted(self.spk2utt)
        self.spks = spks
        self.spk2id = ({s: i for i, s in enumerate(spks)}
                       if spks is not None else None)
        self.use_spk_id = use_spk_id
        if use_spk_id and (self.utt2spk is None or self.spk2id is None):
            raise FileNotFoundError(f"use_spk_id needs {stage_dir}/utt2spk "
                                    f"or spk2utt")
        self.use_ph = use_ph
        if use_ph:
            ph_path = os.path.join(stage_dir, "ph.scp")
            if not os.path.exists(ph_path):
                raise FileNotFoundError(f"use_ph needs {ph_path}")
            fid_to_php = load_scp(ph_path)
            self.ph_files = [fid_to_php[fid] for fid in self.utt_ids]
        self.use_mel = dataset_mode == "ph2m"  # m2w training is not ported
        self.input_transform = (input_transform if input_transform is not None
                                else transform)
        self.output_transform = output_transform
        self.allow_cache = allow_cache
        self.caches: dict[int, dict] = {}

    def __getitem__(self, idx: int) -> dict:
        if self.allow_cache and idx in self.caches:
            return self.caches[idx]
        art = np.load(self.art_files[idx])  # (T', C)
        if self.input_transform is not None:
            art = self.input_transform(art)
        audio = self.audio_load_fn(self.audio_files[idx])
        if self.output_transform is not None:
            audio = self.output_transform(audio)
        items = {"art": art, "audio": audio}
        if self.use_mel:
            items["mel"] = self.mel_load_fn(self.mel_files[idx])[: len(art)]
        if self.use_spk_id:
            items["spk_id"] = self.spk2id[self.utt2spk[self.utt_ids[idx]]]
        if self.use_ph:
            items["ph"] = np.load(self.ph_files[idx])
        if self.allow_cache:
            self.caches[idx] = items
        return items

    def __len__(self) -> int:
        return len(self.audio_files)


def _speakers(stage_dir: str) -> tuple[dict | None, dict | None]:
    """``(utt2spk, spk2utt)`` of a data stage from whichever of its
    ``utt2spk`` and ``spk2utt`` files exist, each derived from the other
    where missing; ``(None, None)`` without either."""
    spk2utt = utt2spk = None
    path = os.path.join(stage_dir, "spk2utt")
    if os.path.exists(path):
        with open(path) as f:
            spk2utt = {ls[0]: ls[1:] for ls in map(str.split, f) if ls}
    path = os.path.join(stage_dir, "utt2spk")
    if os.path.exists(path):
        utt2spk = dict(load_scp(path).items())
    if spk2utt is None and utt2spk is not None:
        spk2utt = {}
        for utt, spk in utt2spk.items():
            spk2utt.setdefault(spk, []).append(utt)
    if utt2spk is None and spk2utt is not None:
        utt2spk = {u: s for s, us in spk2utt.items() for u in us}
    return utt2spk, spk2utt


class MelArtDataset:
    """(mel, art) pairs: mels from the dump directory, articulatory
    features (.npy) through ``<data_root>/<stage>/feats.scp`` under the
    utterance id (``<utt>`` of ``<utt>.h5`` or ``<utt>-feats.npy``; the
    JAX package looks an npy dump up as ``<utt>-feats``); both cut to the
    shorter."""

    def __init__(self, root_dir: str, mel_query: str = "*.h5",
                 mel_load_fn=None, mel_length_threshold: int | None = None,
                 allow_cache: bool = False, transform=None,
                 data_root: str = "data"):
        self.mel_load_fn = mel_load_fn or (lambda p: read_hdf5(p, "feats"))
        mel_files, = _above(sorted(find_files(root_dir, mel_query)),
                            self.mel_load_fn, mel_length_threshold, "mel")
        if not mel_files:
            raise FileNotFoundError(f"Not found any mel files in {root_dir}.")
        self.mel_files = mel_files
        self.utt_ids = [_utt_id(f) for f in mel_files]
        scp = load_scp(os.path.join(data_root, _stage_from_root(root_dir),
                                    "feats.scp"))
        self.art_files = [scp[u] for u in self.utt_ids]
        self.transform = transform
        self.allow_cache = allow_cache
        self.caches: dict[int, tuple] = {}

    def __getitem__(self, idx: int) -> tuple:
        if self.allow_cache and idx in self.caches:
            return self.caches[idx]
        mel = self.mel_load_fn(self.mel_files[idx])
        art = np.load(self.art_files[idx])
        if self.transform is not None:
            art = self.transform(art)
        items = (mel[: len(art)], art[: len(mel)])
        if self.allow_cache:
            self.caches[idx] = items
        return items

    def __len__(self) -> int:
        return len(self.mel_files)


class FileDataset:
    """The files of a directory matching ``query`` (sorted), read by
    ``load_fn``: ``(utt_id, data)`` items with ``return_utt_id``, else the
    data. It serves the preprocessing CLIs where the JAX package uses
    ``AudioDataset`` and ``MelDataset``."""

    def __init__(self, root_dir: str, query: str, load_fn,
                 return_utt_id: bool = False):
        self.files = sorted(find_files(root_dir, query))
        if not self.files:
            raise FileNotFoundError(f"Not found any {query} files in "
                                    f"{root_dir}.")
        self.load_fn = load_fn
        self.utt_ids = [_utt_id(f) for f in self.files]
        self.return_utt_id = return_utt_id

    def __getitem__(self, idx: int):
        data = self.load_fn(self.files[idx])
        return (self.utt_ids[idx], data) if self.return_utt_id else data

    def __len__(self) -> int:
        return len(self.files)


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
            self.utt_ids = [_utt_id(f) for f in files]
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


class AudioSCPDataset:
    """wav.scp-driven audio: ``(audio, fs)`` items, ``audio`` alone with
    ``return_sampling_rate=False``, each after its utterance id with
    ``return_utt_id`` (reference scp_dataset.py:49-173). Piped entries and
    ``segments`` as ``WavScpLoader``."""

    def __init__(self, wav_scp: str, segments: str | None = None,
                 return_utt_id: bool = False,
                 return_sampling_rate: bool = True):
        self.loader = WavScpLoader(wav_scp, segments=segments)
        self.utt_ids = list(self.loader.keys())
        self.return_utt_id = return_utt_id
        self.return_sampling_rate = return_sampling_rate

    def __getitem__(self, idx: int):
        utt_id = self.utt_ids[idx]
        audio, fs = self.loader[utt_id]
        items = (audio, fs) if self.return_sampling_rate else (audio,)
        if self.return_utt_id:
            return (utt_id, *items)
        return items if self.return_sampling_rate else audio

    def __len__(self) -> int:
        return len(self.utt_ids)


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
