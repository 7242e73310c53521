"""A corpus cache on the card: random-window training batches gathered from
tensors that stay on ``device`` (port of
``articulatory_tpu/data/device_cache.py``).

One pass over the dataset lays every stream out flat on the device, each
utterance after the one before it, with an offset per utterance:

- a2w and w2a: the audio (``(N,)`` samples, or ``(N, F)`` rows of
  frame-rate features) and the articulatory features ``(N', C)``, the art
  cut to ``len(audio) // hop_size`` frames; with the generator's ``use_ar``
  each utterance of the AR stream (the audio for a2w, the art for w2a) is
  preceded by ``ar_len = ar_input // out_channels`` zeros, so an AR past
  that starts before the utterance comes out zero-padded, as the host
  collater pads it;
- a2m and m2a: the mels and the art, both cut to the shorter.

Utterances with no more than ``batch_max_steps // hop_size`` frames are
left out. Each batch is one gather per stream on the device: the host
draws the ``(utt, start)`` pairs with ``np.random.default_rng(seed +
epoch)`` exactly as the JAX package's cache does (``sample_indices``),
computes each window's first index in int64 (a corpus of a few thousand
10 s utterances passes 2**31 samples), and the device adds the window's
positions and gathers. The batch has the keys and layout of the port's
collaters for the same draws (``x`` a 1-tuple, ``y``, and ``ar``), its
tensors on ``device``.

``canonical_cache_mode`` maps a ``dataset_mode`` onto the cache's modes
(the generic x2y modes through ``collate.parse_dataset_mode``), or None
where the cache holds no stream of the mode.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from articulatory_tpu_torch.data.collate import parse_dataset_mode

MODES = ("a2w", "w2a", "a2m", "m2a")


def canonical_cache_mode(dataset_mode: str) -> str | None:
    """The cache mode that serves ``dataset_mode``, or None."""
    if dataset_mode in MODES:
        return dataset_mode
    if dataset_mode in ("a2w_mult", "a2w_pcd"):
        return None
    try:
        x_key, y_key = parse_dataset_mode(dataset_mode)[:2]
    except ValueError:
        return None
    return {("art", "audio"): "a2w",
            ("audio", "art"): "w2a"}.get((x_key, y_key))


class _Stream:
    """Utterances of one stream, flat on the device, each after ``pad``
    zero rows; ``offsets[u]`` is the flat index of utterance u's first
    (padding) row."""

    def __init__(self, arrays: list[np.ndarray], pad: int, device):
        lengths = np.asarray([pad + len(a) for a in arrays], np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        flat = np.zeros((int(lengths.sum()),) + arrays[0].shape[1:],
                        np.float32)
        for off, a in zip(self.offsets, arrays):
            flat[off + pad: off + pad + len(a)] = a
        self.data = torch.from_numpy(flat).to(device)

    def gather(self, first: np.ndarray, length: int) -> torch.Tensor:
        """Rows ``[first, first + length)`` of the flat stream for each
        first index: (B, length, ...)."""
        first = torch.from_numpy(first).to(self.data.device,
                                           non_blocking=True)
        idx = first[:, None] + torch.arange(length, device=self.data.device)
        rows = self.data.index_select(0, idx.reshape(-1))
        return rows.view(len(first), length, *self.data.shape[1:])


class DeviceCachedBatcher:
    """Iterable of random-window batches gathered on ``device`` from a
    ``SpeechDataset`` (items with "audio" and "art") or a ``MelArtDataset``
    ((mel, art) pairs); an epoch is utterances // batch size batches (at
    least one)."""

    def __init__(self, dataset, config: dict, *, batch_size: int,
                 seed: int = 0, device="cuda"):
        mode = config.get("dataset_mode", "a2w")
        if mode not in MODES:
            raise ValueError(f"device cache does not support mode {mode}")
        gp = config.get("generator_params", {})
        if gp.get("use_spk_id") or gp.get("use_ph"):
            raise ValueError("device cache does not support spk/ph hooks")
        if config.get("use_pcd"):
            raise ValueError("device cache does not support PCD training: "
                             "no pitch or periodicity stream is cached")
        if config.get("generator2_type"):
            raise ValueError("device cache does not support two-stage "
                             "(generator2) configs: the collater's 'ar2' "
                             "windows are not cached")
        if gp.get("aux_context_window", 0):
            raise ValueError("device cache does not support "
                             "aux_context_window != 0")
        self.mode = mode
        self.hop = int(config["hop_size"])
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        self.device = torch.device(device)
        self.is_melart = mode in ("a2m", "m2a")
        self.frames = int(config["batch_max_steps"]) // self.hop
        self.samples = self.frames * self.hop
        self.ar_len = (int(gp.get("ar_input", 512) / gp.get("out_channels", 1))
                       if gp.get("use_ar", False) and not self.is_melart
                       else 0)
        self._build(dataset)
        self.steps_per_epoch = max(1, self.n_utts // batch_size)

    def _build(self, dataset) -> None:
        xs, arts = [], []  # audio or mel; art
        for i in range(len(dataset)):
            d = dataset[i]
            if self.is_melart:
                mel, art = (d["mel"], d["art"]) if isinstance(d, dict) else d
                t = min(len(mel), len(art))
                x, art = np.asarray(mel[:t], np.float32), art[:t]
            else:
                x = np.asarray(d["audio"], np.float32)
                art = d["art"][: len(x) // self.hop]
                x = x[: len(art) * self.hop]
            if len(art) < self.frames + 1:
                continue
            xs.append(x)
            arts.append(np.asarray(art, np.float32))
        self.n_utts = len(arts)
        if self.n_utts == 0:
            raise ValueError("no utterance is long enough for the window")
        self.lengths = np.asarray([len(a) for a in arts], np.int64)  # frames
        self.x = _Stream(xs, self.ar_len if self.mode == "a2w" else 0,
                         self.device)
        self.art = _Stream(arts, self.ar_len if self.mode == "w2a" else 0,
                           self.device)
        self.resident_bytes = sum(s.data.numel() * s.data.element_size()
                                  for s in (self.x, self.art))
        logging.info(f"device corpus cache: {self.n_utts} utterances, "
                     f"{self.resident_bytes / 1e6:.1f} MB resident on "
                     f"{self.device}")

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.steps_per_epoch

    def sample_indices(self, rng: np.random.Generator
                       ) -> tuple[np.ndarray, np.ndarray]:
        """One batch of (utt, start) draws, starts in [0, frames of the
        utterance - window frames), the host collater's range."""
        utts = rng.integers(0, self.n_utts, self.batch_size)
        highs = self.lengths[utts] - self.frames  # exclusive
        starts = (rng.random(self.batch_size) * highs).astype(np.int64)
        return utts.astype(np.int32), starts.astype(np.int32)

    def batch_at(self, utts, starts) -> dict:
        """The batch of explicit (utt, start) draws."""
        utts = np.asarray(utts, np.int64)
        starts = np.asarray(starts, np.int64)
        if self.is_melart:
            mel = self.x.gather(self.x.offsets[utts] + starts, self.frames)
            art = self.art.gather(self.art.offsets[utts] + starts,
                                  self.frames)
            if self.mode == "m2a":
                return {"x": (mel,), "y": art}
            return {"x": (art,), "y": mel}
        a2w = self.mode == "a2w"
        audio_pad, art_pad = (self.ar_len, 0) if a2w else (0, self.ar_len)
        audio_first = self.x.offsets[utts] + audio_pad + starts * self.hop
        art_first = self.art.offsets[utts] + art_pad + starts
        audio = self.x.gather(audio_first, self.samples)
        if audio.dim() == 2:
            audio = audio[..., None]  # (B, T, 1)
        art = self.art.gather(art_first, self.frames)
        out = {"x": (art,), "y": audio} if a2w else {"x": (audio,), "y": art}
        if self.ar_len:
            # the AR past of the output stream, inside its zero padding
            out["ar"] = (self.x.gather(audio_first - self.ar_len,
                                       self.ar_len)[..., None] if a2w else
                         self.art.gather(art_first - self.ar_len,
                                         self.ar_len))
        return out

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        for _ in range(self.steps_per_epoch):
            yield self.batch_at(*self.sample_indices(rng))
