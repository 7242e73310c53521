"""Native host C++ batch assembly for a2w random-window training (port of
``articulatory_tpu/data/native_loader.py``).

``csrc/batcher.cpp`` (the port's copy of the JAX package's
``native/src/batcher.cpp``) is built with g++ at first use
(``ops/_build.py::host_library``) and bound with ctypes. ``NativeBatcher``
reads the corpus's .npy files into C++ memory once; ``collate`` crops and
packs a batch in its worker pool, each item's window start drawn from a
per-batch seed. A failed build raises: the library is built from the
checkout, so there is nothing to fall back from (the JAX package warns and
takes its Python loader where its library was never built).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from articulatory_tpu_torch.ops import _build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.host_library("batcher")
    lib.ab_create.restype = ctypes.c_void_p
    lib.ab_create.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int]
    lib.ab_destroy.argtypes = [ctypes.c_void_p]
    lib.ab_add_utterance.restype = ctypes.c_int64
    lib.ab_add_utterance.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_char_p]
    for fn in (lib.ab_num_utterances, lib.ab_art_dim):
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.ab_utt_frames.restype = ctypes.c_int64
    lib.ab_utt_frames.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    floats = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.ab_collate.restype = ctypes.c_int
    lib.ab_collate.argtypes = [
        ctypes.c_void_p, np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int, ctypes.c_uint64, floats, floats, ctypes.c_void_p]
    return lib


class NativeBatcher:
    """The C++ corpus and its random-window crop (a2w): ``collate(indices,
    seed)`` -> ``{"x": (art,), "y": audio, "audio", "art"[, "ar"]}`` in
    the collater's layout."""

    def __init__(self, batch_max_steps: int, hop_size: int, ar_len: int = 0,
                 n_threads: int = 4):
        self._lib = _lib()
        self._h = self._lib.ab_create(batch_max_steps, hop_size, ar_len,
                                      n_threads)
        self.batch_max_steps = batch_max_steps
        self.hop_size = hop_size
        self.ar_len = ar_len
        self.frames = batch_max_steps // hop_size

    def add_utterance(self, audio_npy: str, art_npy: str) -> int:
        idx = self._lib.ab_add_utterance(self._h, audio_npy.encode(),
                                         art_npy.encode())
        if idx < 0:
            raise IOError(f"failed to load {audio_npy} / {art_npy}")
        return int(idx)

    def __len__(self) -> int:
        return int(self._lib.ab_num_utterances(self._h))

    @property
    def art_dim(self) -> int:
        return int(self._lib.ab_art_dim(self._h))

    def utt_frames(self, idx: int) -> int:
        return int(self._lib.ab_utt_frames(self._h, idx))

    def collate(self, indices, seed: int) -> dict:
        n = len(indices)
        audio = np.empty((n, self.batch_max_steps), np.float32)
        art = np.empty((n, self.frames, self.art_dim), np.float32)
        ar = np.empty((n, self.ar_len), np.float32) if self.ar_len else None
        status = self._lib.ab_collate(
            self._h, np.asarray(indices, np.int64), n, ctypes.c_uint64(seed),
            audio, art,
            None if ar is None else ar.ctypes.data_as(ctypes.c_void_p))
        if status != 0:
            raise ValueError("ab_collate failed (an utterance shorter than "
                             "the window)")
        out = {"x": (art,), "y": audio[..., None], "audio": audio[..., None],
               "art": art}
        if ar is not None:
            out["ar"] = ar[..., None]
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ab_destroy(self._h)
            self._h = None


class NativeDataLoader:
    """Epochs of native batches over a ``SpeechDataset``'s files (a2w,
    random_window): the usable utterances (more frames than the window)
    shuffled by ``np.random.default_rng(seed + epoch)``, full batches only,
    each collated with seed ``(seed * 1000003 + epoch * 7919 + batch) mod
    2**32``. Audio in hdf5 is written once as .npy under
    ``<dump>/.native_cache`` for the C++ reader."""

    def __init__(self, dataset, *, batch_size: int, batch_max_steps: int,
                 hop_size: int, ar_len: int = 0, seed: int = 0,
                 n_threads: int = 8):
        self.batcher = NativeBatcher(batch_max_steps, hop_size, ar_len,
                                     n_threads)
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        for audio_path, art_path in zip(dataset.audio_files,
                                        dataset.art_files):
            if audio_path.endswith(".h5"):
                audio_path = _npy_copy(audio_path)
            self.batcher.add_utterance(audio_path, art_path)
        frames = batch_max_steps // hop_size
        self.indices = [i for i in range(len(self.batcher))
                        if self.batcher.utt_frames(i) > frames]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.indices) // self.batch_size

    def __iter__(self):
        order = np.asarray(self.indices)
        np.random.default_rng(self.seed + self.epoch).shuffle(order)
        for b in range(len(self)):
            seed = (self.seed * 1_000_003 + self.epoch * 7919 + b) & 0xFFFFFFFF
            yield self.batcher.collate(
                list(order[b * self.batch_size:(b + 1) * self.batch_size]),
                seed)


def _npy_copy(h5_path: str) -> str:
    """The .npy copy of an hdf5 dump's "wave", written where missing."""
    from articulatory_tpu_torch.utils.io import read_hdf5

    cache = os.path.join(os.path.dirname(h5_path), ".native_cache")
    os.makedirs(cache, exist_ok=True)
    path = os.path.join(cache, os.path.basename(h5_path) + "-wave.npy")
    if not os.path.exists(path):
        np.save(path, read_hdf5(h5_path, "wave").astype(np.float32))
    return path
