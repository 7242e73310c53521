"""Training collater: lists of utterances -> fixed-shape numpy batches in
NLC layout (port of ``articulatory_tpu/data/collate.py::SpeechCollater``).

The port carries the a2w path with ``package_mode: random_window`` (a
random fixed-size crop per utterance, drawn from the collater's numpy
generator in the JAX package's order, so one seed gives both packages the
same crops): x = (art window,), y = audio (B, T, 1), and with ``use_ar``
the waveform past ``ar`` (B, ar_input, 1), zero-padded at the start of an
utterance. It takes every ``dataset_mode`` that ``parse_dataset_mode``
resolves to those streams: ``a2w``, ``default`` and the generic x2y modes
(the MRI recipe's among them). Other dataset modes, package modes, speaker
ids and phonemes raise ``NotImplementedError``.

``parse_dataset_mode`` and ``is_wave_output_mode`` are the JAX package's
rules (``articulatory_tpu/data/collate.py``), copied.
"""

from __future__ import annotations

import logging

import numpy as np

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
                 config: dict | None = None,
                 rng: np.random.Generator | None = None):
        if batch_max_steps % hop_size != 0:
            raise ValueError("batch_max_steps must be a multiple of hop_size")
        config = config or {}
        gp = config.get("generator_params", {})
        x_key, y_key = parse_dataset_mode(dataset_mode)[:2]
        if (x_key, y_key) != ("art", "audio"):
            raise NotImplementedError(f"training dataset_mode {dataset_mode!r} "
                                      f"({x_key} to {y_key}) is not ported "
                                      "yet")
        package_mode = config.get("package_mode", "random_window")
        if package_mode != "random_window":
            raise NotImplementedError(f"package_mode {package_mode!r} is not "
                                      "ported yet")
        if "generator2_params" in config or gp.get("use_spk_id") or gp.get(
                "use_ph") or gp.get("use_ph_loss"):
            raise NotImplementedError("cascades, speaker ids and phonemes are "
                                      "not ported yet")
        self.batch_max_steps = batch_max_steps
        self.batch_max_frames = batch_max_steps // hop_size
        self.hop_size = hop_size
        self.aux_context_window = aux_context_window
        self.rng = rng or np.random.default_rng()
        # waveform-output modes carry the waveform-domain AR past
        self.ar_len = (int(gp.get("ar_input", 512) / gp.get("out_channels", 1))
                       if gp.get("use_ar", False) else None)
        self.start_offset = aux_context_window
        self.end_offset = -(self.batch_max_frames + aux_context_window)

    def __call__(self, batch: list[dict]) -> dict:
        audios, arts = [], []
        for d in batch:
            art = d["art"][: int(len(d["audio"]) / self.hop_size)]
            if len(art) + self.end_offset > self.start_offset:
                audios.append(d["audio"])
                arts.append(art)
        if len(arts) < len(batch):
            logging.warning(f"collater dropped {len(batch) - len(arts)} "
                            f"utterances shorter than the "
                            f"{self.batch_max_frames}-frame window")
        start_frames = np.array([
            self.rng.integers(self.start_offset, len(c) + self.end_offset)
            for c in arts])
        wav_starts = start_frames * self.hop_size
        art_starts = start_frames - self.aux_context_window
        art_ends = (start_frames + self.batch_max_frames
                    + self.aux_context_window)
        audio = np.stack([a[s:s + self.batch_max_steps]
                          for a, s in zip(audios, wav_starts)]
                         ).astype(np.float32)[..., None]  # (B, T, 1)
        art = np.stack([a[s:e] for a, s, e in zip(arts, art_starts, art_ends)]
                       ).astype(np.float32)  # (B, T', C)
        out = {"audio": audio, "art": art, "x": (art,), "y": audio}
        if self.ar_len is not None:
            windows = []
            for wav, start in zip(audios, wav_starts):
                w = wav[max(0, start - self.ar_len): start]
                windows.append(np.pad(w, (self.ar_len - len(w), 0)))
            out["ar"] = np.stack(windows).astype(np.float32)[..., None]
        return out
