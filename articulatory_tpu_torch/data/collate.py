"""Training collater: lists of utterances -> fixed-shape numpy batches in
NLC layout (port of ``articulatory_tpu/data/collate.py::SpeechCollater``).

The port carries the a2w path with ``package_mode: random_window`` (a
random fixed-size crop per utterance, drawn from the collater's numpy
generator in the JAX package's order, so one seed gives both packages the
same crops): x = (art window,), y = audio (B, T, 1), and with ``use_ar``
the waveform past ``ar`` (B, ar_input, 1), zero-padded at the start of an
utterance. Other dataset modes, package modes, speaker ids and phonemes
raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging

import numpy as np


class SpeechCollater:
    def __init__(self, batch_max_steps: int = 20480, hop_size: int = 256,
                 aux_context_window: int = 0, dataset_mode: str = "a2w",
                 config: dict | None = None,
                 rng: np.random.Generator | None = None):
        if batch_max_steps % hop_size != 0:
            raise ValueError("batch_max_steps must be a multiple of hop_size")
        config = config or {}
        gp = config.get("generator_params", {})
        if dataset_mode not in ("a2w", "default"):
            raise NotImplementedError(f"training dataset_mode {dataset_mode!r} "
                                      "is not ported yet")
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
