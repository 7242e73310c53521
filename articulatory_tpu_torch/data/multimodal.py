"""Multi-modality data (port of ``articulatory_tpu/data/multimodal.py``),
e.g. EMA and MRI corpora pooled:

- ``WavArtMultDataset``: audio and articulatory pairs from one hdf5 dump
  directory per modality, each modality's audio resampled from its rate
  (``sampling_rates[m]``) to the common ``sampling_rate``; items ``(audio,
  art, modality)``;
- ``ArtSCPMultDataset``: a 3-column scp, ``fid path modality``; items
  ``(art, modality)``, led by the fid with ``return_utt_id`` (the
  ``a2w_mult`` decode's input);
- ``SpeechCollaterMult``: random-window crops after trimming each
  utterance to whole hops of the common rate and interpolating its art
  linearly onto that frame grid; ``x = ([per-modality art batch or None,
  ...],)``, ``y`` the waveform crops (B, T, 1), and with ``ar_len`` the
  waveform past ``ar``.

As in the JAX package, the generator that reads the per-modality list
(an ``in_list`` model) is the user's: no model of the registry takes one.
Transforms are a callable or the reference's ``"10*f0"`` string. The
reference's options that no caller here sets (caches, length thresholds,
npy queries, ignored modalities, the collater's aux context window) are
left out.
"""

from __future__ import annotations

import os

import numpy as np

from articulatory_tpu_torch.data.datasets import _stage_from_root
from articulatory_tpu_torch.ops.audio import resample
from articulatory_tpu_torch.utils.io import find_files, load_scp, read_hdf5


def _apply_art_transform(transform, art: np.ndarray) -> np.ndarray:
    """A callable transform, or the reference's ``"10*f0"`` string (pitch,
    column 0, times 10)."""
    if callable(transform):
        return transform(art)
    if transform == "10*f0":
        art = art.copy()
        art[:, 0] *= 10
    return art


def _interp_linear_np(x: np.ndarray, size: int) -> np.ndarray:
    """``F.interpolate(mode='linear', align_corners=False)`` of (T, C) to
    ``size`` frames, in float64 positions (the JAX package's numpy
    version)."""
    t_in = len(x)
    pos = (np.arange(size) + 0.5) * (t_in / size) - 0.5
    pos = np.clip(pos, 0, t_in - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, t_in - 1)
    w = (pos - lo)[:, None]
    return x[lo] * (1 - w) + x[hi] * w


class WavArtMultDataset:
    """Audio and articulatory pairs pooled from per-modality hdf5 dump
    directories (``root_dirs[m]``, art through
    ``<data_root>/<stage>/feats.scp``)."""

    def __init__(self, root_dirs, transform=None, sampling_rate=None,
                 sampling_rates=None, data_root: str = "data"):
        self.mod_is: list[int] = []
        self.audio_files: list[str] = []
        self.art_files: list[str] = []
        for mod_i, root_dir in enumerate(root_dirs):
            audio_files = sorted(find_files(root_dir, "*.h5"))
            if not audio_files:
                raise FileNotFoundError(f"Not found any audio files in "
                                        f"{root_dir}.")
            utt_ids = [os.path.splitext(os.path.basename(f))[0]
                       for f in audio_files]
            feats_path = os.path.join(data_root, _stage_from_root(root_dir),
                                      "feats.scp")
            if not os.path.exists(feats_path):
                raise FileNotFoundError(f"missing {feats_path}")
            fid_to_artp = load_scp(feats_path)
            self.audio_files += audio_files
            self.art_files += [fid_to_artp[fid] for fid in utt_ids]
            self.mod_is += [mod_i] * len(audio_files)
        self.transform = transform or ""
        self.sampling_rate = sampling_rate
        self.sampling_rates = sampling_rates

    def __getitem__(self, idx: int):
        modality_i = self.mod_is[idx]
        audio = resample(read_hdf5(self.audio_files[idx], "wave"),
                         self.sampling_rates[modality_i], self.sampling_rate)
        art = _apply_art_transform(self.transform,
                                   np.load(self.art_files[idx]))
        return audio, art, modality_i

    def __len__(self) -> int:
        return len(self.audio_files)


class ArtSCPMultDataset:
    """A 3-column scp dataset: ``fid path modality`` per line."""

    def __init__(self, feats_scp: str, return_utt_id: bool = False,
                 transform=None):
        self.utt_ids, self.input_paths, self.modalities = [], [], []
        with open(feats_scp) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                self.utt_ids.append(parts[0])
                self.input_paths.append(parts[1])
                self.modalities.append(int(parts[2]))
        self.return_utt_id = return_utt_id
        self.transform = transform or ""

    def __getitem__(self, idx: int):
        art = _apply_art_transform(self.transform,
                                   np.load(self.input_paths[idx]))
        if self.return_utt_id:
            return self.utt_ids[idx], art, self.modalities[idx]
        return art, self.modalities[idx]

    def __len__(self) -> int:
        return len(self.utt_ids)


class SpeechCollaterMult:
    """The multi-modality random-window crop."""

    def __init__(self, batch_max_steps: int = 20480, hop_size: int = 256,
                 ar_len=None, hop_sizes=None, sampling_rate=None,
                 sampling_rates=None,
                 rng: np.random.Generator | None = None):
        if batch_max_steps % hop_size != 0:
            raise ValueError("batch_max_steps must be a multiple of hop_size")
        self.batch_max_steps = batch_max_steps
        self.batch_max_frames = batch_max_steps // hop_size
        self.hop_size = hop_size
        self.ar_len = ar_len
        self.hop_sizes = hop_sizes
        # art frames a trimmed audio sample spans, per modality
        self.rem_art_coefs = [sr / sampling_rate / h
                              for h, sr in zip(hop_sizes, sampling_rates)]
        self.rng = rng or np.random.default_rng()

    def __call__(self, batch, rng: np.random.Generator | None = None
                 ) -> dict:
        rng = self.rng if rng is None else rng
        audios: list[list[np.ndarray]] = [[] for _ in self.hop_sizes]
        arts: list[list[np.ndarray]] = [[] for _ in self.hop_sizes]
        for audio, art, modality_i in batch:
            rem_audio = len(audio) % self.hop_size
            if rem_audio > 0:
                audio = audio[:-rem_audio]
                rem_art = round(rem_audio * self.rem_art_coefs[modality_i])
                if rem_art > 0:
                    art = art[:-rem_art]
            art = _interp_linear_np(art.astype(np.float32),
                                    len(audio) // self.hop_size)
            audios[modality_i].append(audio)
            arts[modality_i].append(art)

        flat_audios = [a for group in audios for a in group]
        art_lengths = [len(a) for group in arts for a in group]
        start_frames = np.array([
            rng.integers(0, n - self.batch_max_frames)
            for n in art_lengths])
        y_starts = start_frames * self.hop_size
        y_batch = np.stack([y[s:s + self.batch_max_steps] for y, s in
                            zip(flat_audios, y_starts)]
                           ).astype(np.float32)[..., None]
        art_ends = start_frames + self.batch_max_frames
        x_batch, i = [], 0
        for group in arts:
            if not group:
                x_batch.append(None)
                continue
            crops = []
            for art in group:
                crops.append(art[start_frames[i]:art_ends[i]])
                i += 1
            x_batch.append(np.stack(crops).astype(np.float32))
        out = {"x": (x_batch,), "y": y_batch}
        if self.ar_len is not None:
            windows = []
            for x, start in zip(flat_audios, y_starts):
                w = x[max(0, start - self.ar_len): start]
                windows.append(np.pad(w, (self.ar_len - len(w), 0)))
            out["ar"] = np.stack(windows).astype(np.float32)[..., None]
        return out
