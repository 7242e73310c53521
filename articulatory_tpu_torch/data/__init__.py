"""The datasets, collaters, sampler and loader the JAX package's
``articulatory_tpu/data/__init__.py`` exports, each resolved on first use,
so the feature CLIs, which import ``data/datasets.py``, start without
torch."""

import importlib

_NAMES = {
    **{name: "datasets" for name in (
        "SpeechDataset", "MelArtDataset", "AudioDataset", "MelDataset",
        "ArtDataset", "AudioSCPDataset", "MelSCPDataset", "ArtSCPDataset")},
    **{name: "collate" for name in (
        "SpeechCollater", "CollaterMelArt", "Collater",
        "combine_fixed_length")},
    "SizeAwareSampler": "samplers",
    "DataLoader": "loader",
    **{name: "multimodal" for name in (
        "WavArtMultDataset", "ArtSCPMultDataset", "SpeechCollaterMult")},
}

__all__ = list(_NAMES)


def __getattr__(name):
    if name in _NAMES:
        return getattr(importlib.import_module(
            f"{__name__}.{_NAMES[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
