"""Training collaters: lists of utterances -> fixed-shape numpy batches in
NLC layout (port of ``articulatory_tpu/data/collate.py``).

``SpeechCollater`` batches the streams of its dataset mode:

- a2w (``a2w``, ``default`` and the generic x2y modes, the MRI recipe's
  among them): x = (art window,), y = audio (B, T, 1);
- m2w: x = (mel window,), y = audio, the mels windowed with the art
  frames (the art stream still sets the window's bounds);
- w2a: x = (audio window,), y = art (B, T', C);
- ph2a and ph2m: x = (phoneme ids (B, T'),), y = art or mel (B, T', C),
  the phoneme and mel streams windowed with the art frames.

in one of three ``package_mode``s, each the JAX package's:

- ``random_window`` (the default): a random fixed-size crop per utterance,
  drawn from the collater's numpy generator in the JAX package's order, so
  one seed gives both packages the same crops;
- ``window``: every utterance (audio cut to its art frames x hop)
  concatenated along time and cut into windows of ``batch_max_steps``
  samples and ``batch_max_steps // hop_size`` frames, the tail
  zero-padded (``combine_fixed_length``); a batch holds as many windows as
  its utterances fill;
- ``pad``: every utterance padded to the longest, audio with ``pad_audio``,
  art with ``pad_art``, phoneme ids with ``pad_ph``.

AR pasts and mels are batched in ``random_window`` only: the JAX package's
collater raises for a feature AR past in ``window`` mode and fails on the
missing start offsets or mel stream in the others, so the port refuses
those configurations when the collater is built.

``use_spk_id`` adds ``spk_id`` (B,) int32, ``use_ph`` the phoneme window
``ph`` (B, T') int32. With the generator's ``use_ar`` the AR past of the
output stream is ``ar``: waveform samples (B, ar_input, 1) or feature
frames (B, ar_input // out_channels, C); in a cascade (``generator2_type``)
``ar`` is the feature past and ``ar2`` the waveform past of
``generator2_params``' length, as the JAX package batches them. AR pasts
are zero-padded at the start of an utterance. An audio stream of
frame-rate features, ``(T, F)`` per utterance (the w2a recipes' MFCCs,
with ``hop_size`` 1), is batched as ``(B, T, F)``; the JAX package's
collater appends an axis to it in ``random_window`` mode too, a 4-D batch
no model reads.

``CollaterMelArt`` is the a2m / m2a / art crop of (mel, art) pairs, and
``Collater`` the legacy Parallel WaveGAN (audio, mel) crop, with
``use_noise_input`` a standard-normal noise input drawn from the same
generator, x = (noise, aux window); both copied from the JAX package.

``parse_dataset_mode`` and ``is_wave_output_mode`` are the JAX package's
rules (``articulatory_tpu/data/collate.py``), copied.
"""

from __future__ import annotations

import logging

import numpy as np

PACKAGE_MODES = ("random_window", "window", "pad")


def combine_fixed_length(arrays: list[np.ndarray], length: int) -> np.ndarray:
    """The arrays concatenated along time (float32) and reshaped into
    ``(n, length, feat...)`` windows, the tail zero-padded."""
    total = sum(a.shape[0] for a in arrays)
    if total % length:
        pad = length - total % length
        arrays = list(arrays) + [
            np.zeros((pad,) + arrays[0].shape[1:], dtype=np.float32)]
        total += pad
    cat = np.concatenate([a.astype(np.float32) for a in arrays], axis=0)
    return cat.reshape((total // length, length) + cat.shape[1:])


def _padded(arrays: list[np.ndarray], length: int, value, dtype
            ) -> np.ndarray:
    """The arrays (as ``dtype``) padded with ``value`` to ``length`` rows
    and stacked."""
    return np.stack([np.concatenate([
        a.astype(dtype), np.full((length - len(a),) + a.shape[1:], value,
                                 dtype)]) for a in arrays])


_NAMED_MODES = {
    "a2w": ("art", "audio", True, False, True),
    "w2a": ("audio", "art", True, False, True),
    "ph2a": ("ph", "art", False, False, True),
    "ph2m": ("ph", "mel", False, True, False),
    "m2w": ("mel", "audio", True, True, False),
    # the config omitted the key; the articulatory default is a2w
    "default": ("art", "audio", True, False, True),
}


def parse_dataset_mode(dataset_mode: str) -> tuple[str, str, bool, bool, bool]:
    """Resolve ``dataset_mode`` -> (x_key, y_key, use_audio, use_mel,
    use_art).

    The named modes map explicitly; any other name takes the reference's
    generic ``split('2')`` branch (train.py:940-963), whose raw keys are no
    keys of a batch: they resolve, with a warning, onto the streams that
    branch loads, x -> 'art' and y -> 'audio' (the articulatory-to-wave
    intent of every such mode, e.g. the MRI recipe's
    ``tracks_npy_minc_punc2wav_adobe_0p9_punc``). The decode-only
    ``a2w_mult`` / ``a2w_pcd`` raise ``ValueError``."""
    if dataset_mode in _NAMED_MODES:
        return _NAMED_MODES[dataset_mode]
    if dataset_mode in ("a2w_mult", "a2w_pcd"):
        raise ValueError(
            f"dataset_mode {dataset_mode!r} is decode-only; train with "
            f"dataset_mode 'a2w'"
            + (" and use_pcd: true" if dataset_mode == "a2w_pcd" else "")
            + " instead")
    xy = dataset_mode.split("2")
    if len(xy) < 2:
        logging.warning(
            f"dataset_mode {dataset_mode!r} has no '2' separator; resolving "
            f"to a2w semantics (the reference raises IndexError here, "
            f"train.py:958)")
        return _NAMED_MODES["a2w"]
    x_key, y_key = xy[0], xy[1]
    produced = {"art", "audio"}  # generic branch: use_audio=True, use_art=True
    if x_key not in produced:
        logging.warning(
            f"dataset_mode {dataset_mode!r}: input stream {x_key!r} is not a "
            f"collater key; resolving to 'art' (the reference raises KeyError "
            f"here, train.py:1069)")
        x_key = "art"
    if y_key not in produced:
        logging.warning(
            f"dataset_mode {dataset_mode!r}: output stream {y_key!r} is not a "
            f"collater key; resolving to 'audio' (the reference raises "
            f"KeyError here, train.py:1070)")
        y_key = "audio"
    return x_key, y_key, True, False, True


def is_wave_output_mode(dataset_mode: str) -> bool:
    """True when decoding this mode produces waveform output (write .wav):
    the named wave modes and every generic x2y mode."""
    if dataset_mode in ("default", "a2w", "a2w_pcd", "a2w_mult", "m2w"):
        return True
    named_non_wave = ("w2a", "ph2a", "ph2m", "a2m", "m2a", "art")
    return dataset_mode not in named_non_wave and "2" in dataset_mode


class SpeechCollater:
    def __init__(self, batch_max_steps: int = 20480, hop_size: int = 256,
                 aux_context_window: int = 0, dataset_mode: str = "a2w",
                 use_spk_id: bool = False, use_ph: bool = False,
                 config: dict | None = None,
                 rng: np.random.Generator | None = None):
        if batch_max_steps % hop_size != 0:
            raise ValueError("batch_max_steps must be a multiple of hop_size")
        config = config or {}
        gp = config.get("generator_params", {})
        (self.x_key, self.y_key, self.use_audio, self.use_mel,
         self.use_art) = parse_dataset_mode(dataset_mode)
        self.package_mode = config.get("package_mode", "random_window")
        if self.package_mode not in PACKAGE_MODES:
            raise ValueError(f"Unknown package_mode: {self.package_mode}")
        fixed = self.package_mode != "random_window"
        if fixed and gp.get("use_ar", False):
            raise NotImplementedError(
                f"AR windows are not supported in {self.package_mode!r} "
                f"package mode (as in the JAX package and the reference, "
                f"train.py:1006-1008)")
        if fixed and self.use_mel:
            raise NotImplementedError(
                f"package_mode {self.package_mode!r} batches no mels "
                f"(dataset_mode {dataset_mode!r}), as in the JAX package")
        self.pad_audio = config.get("pad_audio", 0.0)
        self.pad_art = config.get("pad_art", 0.0)
        self.pad_ph = config.get("pad_ph", 0)
        self.batch_max_steps = batch_max_steps
        self.batch_max_frames = batch_max_steps // hop_size
        self.hop_size = hop_size
        self.aux_context_window = aux_context_window
        self.use_spk_id, self.use_ph = use_spk_id, use_ph
        self.rng = rng or np.random.default_rng()
        # the AR pasts: ``ar`` of the output stream, waveform samples (a2w)
        # or feature frames (w2a, ph2a), and in a cascade ``ar2``, the
        # waveform past of generator2
        self.has_generator2 = "generator2_type" in config
        self.use_ar = gp.get("use_ar", False)
        self.ar_len = self.ar2_len = None
        if self.use_ar:
            self.ar_len = int(gp.get("ar_input", 512)
                              / gp.get("out_channels", 1))
            if "generator2_params" in config:
                g2 = config["generator2_params"]
                self.ar2_len = int(g2.get("ar_input", 512)
                                   / g2.get("out_channels", 1))
            elif self.y_key == "audio":
                self.ar2_len, self.ar_len = self.ar_len, None
        self.start_offset = aux_context_window
        self.end_offset = -(self.batch_max_frames + aux_context_window)

    def __call__(self, batch: list[dict],
                 rng: np.random.Generator | None = None) -> dict:
        rng = self.rng if rng is None else rng
        kept = []
        for d in batch:
            art = d["art"][: int(len(d["audio"]) / self.hop_size)]
            if len(art) + self.end_offset > self.start_offset:
                kept.append((d, art))
        if len(kept) < len(batch):
            logging.warning(f"collater dropped {len(batch) - len(kept)} "
                            f"utterances shorter than the "
                            f"{self.batch_max_frames}-frame window")
        audios = [d["audio"] for d, _ in kept]
        arts = [art for _, art in kept]
        out: dict = {}
        if self.use_spk_id:
            out["spk_id"] = np.asarray([d["spk_id"] for d, _ in kept],
                                       dtype=np.int32)
        if self.package_mode != "random_window":
            return self._fixed(out, audios, arts,
                               [d["ph"] for d, _ in kept] if self.use_ph
                               else None)
        start_frames = np.array([
            rng.integers(self.start_offset, len(c) + self.end_offset)
            for c in arts])
        wav_starts = start_frames * self.hop_size
        art_starts = start_frames - self.aux_context_window
        art_ends = (start_frames + self.batch_max_frames
                    + self.aux_context_window)

        def frames(streams, dtype):  # the art window of each utterance
            return np.stack([a[s:e] for a, s, e in zip(
                streams, art_starts, art_ends)]).astype(dtype)

        audio = np.stack([a[s:s + self.batch_max_steps]
                          for a, s in zip(audios, wav_starts)]
                         ).astype(np.float32)
        if audio.ndim == 2:
            audio = audio[..., None]  # (B, T, 1)
        if self.use_audio:
            out["audio"] = audio
        if self.use_art:
            out["art"] = frames(arts, np.float32)  # (B, T', C)
        if self.use_ph:
            out["ph"] = frames([d["ph"] for d, _ in kept], np.int32)
        if self.use_mel:
            out["mel"] = frames([d["mel"] for d, _ in kept], np.float32)
        out["x"], out["y"] = (out[self.x_key],), out[self.y_key]
        ar = ar2 = None
        if self.ar_len is not None:
            windows = []
            for a, start in zip(arts, art_starts):
                w = a[max(0, start - self.ar_len): start]
                windows.append(np.pad(w, ((self.ar_len - len(w), 0), (0, 0))))
            ar = np.stack(windows).astype(np.float32)  # (B, P, C)
        if self.ar2_len is not None:
            windows = []
            for wav, start in zip(audios, wav_starts):
                w = wav[max(0, start - self.ar2_len): start]
                windows.append(np.pad(w, (self.ar2_len - len(w), 0)))
            ar2 = np.stack(windows).astype(np.float32)[..., None]  # (B, P, 1)
        if self.use_ar and self.has_generator2:
            out["ar"], out["ar2"] = ar, ar2
        elif self.use_ar:
            out["ar"] = ar if ar is not None else ar2
        return out

    def _fixed(self, out: dict, audios: list, arts: list,
               phs: list | None) -> dict:
        """The ``window`` and ``pad`` batches of the kept utterances."""
        audios = [a[: len(art) * self.hop_size].astype(np.float32)
                  for a, art in zip(audios, arts)]
        if self.package_mode == "window":
            audio = combine_fixed_length(
                [a[:, None] if a.ndim == 1 else a for a in audios],
                self.batch_max_steps)
            art = combine_fixed_length(arts, self.batch_max_frames)
            if phs is not None:
                out["ph"] = combine_fixed_length(
                    [p.astype(np.float32) for p in phs],
                    self.batch_max_frames).astype(np.int32)
        else:
            frames = max(len(a) for a in arts)
            audio = _padded(audios, frames * self.hop_size, self.pad_audio,
                            np.float32)
            if audio.ndim == 2:
                audio = audio[..., None]  # (B, T, 1)
            art = _padded(arts, frames, self.pad_art, np.float32)
            if phs is not None:
                out["ph"] = _padded([p[: len(a)] for p, a in zip(phs, arts)],
                                    frames, self.pad_ph, np.int32)
        if self.use_audio:
            out["audio"] = audio
        if self.use_art:
            out["art"] = art
        out["x"], out["y"] = (out[self.x_key],), out[self.y_key]
        return out


class CollaterMelArt:
    """Random-window crop of (mel, art) pairs: x = art, y = mel (a2m,
    art), or x = mel, y = art (m2a)."""

    def __init__(self, batch_max_steps: int = 20480, hop_size: int = 256,
                 aux_context_window: int = 2, ar_len=None,
                 dataset_mode: str = "a2m",
                 rng: np.random.Generator | None = None):
        if ar_len is not None:
            raise NotImplementedError("AR pasts are not supported here (as "
                                      "in the reference)")
        batch_max_steps -= batch_max_steps % hop_size
        self.batch_max_frames = batch_max_steps // hop_size
        self.aux_context_window = aux_context_window
        self.dataset_mode = dataset_mode
        self.rng = rng or np.random.default_rng()
        self.start_offset = aux_context_window
        self.end_offset = -(self.batch_max_frames + aux_context_window)

    def __call__(self, batch, rng: np.random.Generator | None = None
                 ) -> dict:
        rng = self.rng if rng is None else rng
        cs = [b[0] for b in batch]
        arts = [b[1] for b in batch]
        start_frames = np.array([
            rng.integers(self.start_offset, len(c) + self.end_offset)
            for c in cs])
        starts = start_frames - self.aux_context_window
        ends = start_frames + self.batch_max_frames + self.aux_context_window
        c_batch = np.stack([c[s:e] for c, s, e in zip(cs, starts, ends)]
                           ).astype(np.float32)
        art_batch = np.stack([a[s:e] for a, s, e in zip(arts, starts, ends)]
                             ).astype(np.float32)
        if self.dataset_mode == "m2a":
            return {"x": (c_batch,), "y": art_batch}
        return {"x": (art_batch,), "y": c_batch}


class Collater:
    """Legacy Parallel WaveGAN crop of (audio, mel) pairs with the aux
    context window; ``use_noise_input`` adds x[0] = N(0, 1) noise of the
    audio's shape."""

    def __init__(self, batch_max_steps: int = 20480, hop_size: int = 256,
                 aux_context_window: int = 2, use_noise_input: bool = False,
                 rng: np.random.Generator | None = None):
        batch_max_steps -= batch_max_steps % hop_size
        self.batch_max_steps = batch_max_steps
        self.batch_max_frames = batch_max_steps // hop_size
        self.hop_size = hop_size
        self.aux_context_window = aux_context_window
        self.use_noise_input = use_noise_input
        self.rng = rng or np.random.default_rng()
        self.start_offset = aux_context_window
        self.end_offset = -(self.batch_max_frames + aux_context_window)
        self.mel_threshold = self.batch_max_frames + 2 * aux_context_window

    def __call__(self, batch, rng: np.random.Generator | None = None
                 ) -> dict:
        rng = self.rng if rng is None else rng
        batch = [b for b in batch if len(b[1]) > self.mel_threshold]
        xs = [b[0] for b in batch]
        cs = [b[1] for b in batch]
        start_frames = np.array([
            rng.integers(self.start_offset, len(c) + self.end_offset)
            for c in cs])
        x_starts = start_frames * self.hop_size
        c_starts = start_frames - self.aux_context_window
        c_ends = start_frames + self.batch_max_frames + self.aux_context_window
        y_batch = np.stack([x[s:s + self.batch_max_steps]
                            for x, s in zip(xs, x_starts)]
                           ).astype(np.float32)[..., None]  # (B, T, 1)
        c_batch = np.stack([c[s:e] for c, s, e in zip(cs, c_starts, c_ends)]
                           ).astype(np.float32)
        out: dict = {"y": y_batch}
        if self.use_noise_input:
            z_batch = rng.standard_normal(y_batch.shape).astype(
                np.float32)
            out["x"] = (z_batch, c_batch)
        else:
            out["x"] = (c_batch,)
        return out
