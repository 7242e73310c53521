"""The ops the JAX package's ``articulatory_tpu/ops/__init__.py`` exports,
each resolved on first use, so the feature CLIs, which import the
numpy-only ``ops/mel.py``, start without torch.

``stft`` names the function here, as in the JAX package, not the
submodule ``ops/stft.py``: the package does not take the submodule as its
attribute when the import system binds it. ``from
articulatory_tpu_torch.ops.stft import ...`` reaches the submodule's
names; ``articulatory_tpu_torch.ops.stft`` is the function."""

import importlib
import sys
import types

_NAMES = {
    **{name: "conv" for name in (
        "conv1d", "conv_transpose1d", "conv1d_output_length",
        "conv_transpose1d_output_length")},
    **{name: "mel" for name in (
        "mel_filterbank", "hz_to_mel", "mel_to_hz", "logmelfilterbank_np")},
    **{name: "stft" for name in (
        "stft_magnitude", "logmelfilterbank", "stft", "frame_signal")},
    "design_prototype_filter": "pqmf",
    "pqmf_filterbanks": "pqmf",
}

__all__ = list(_NAMES)


def __getattr__(name):
    if name in _NAMES:
        return getattr(importlib.import_module(
            f"{__name__}.{_NAMES[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class _Package(types.ModuleType):
    def __setattr__(self, name, value):
        if name == "stft" and isinstance(value, types.ModuleType):
            return  # the submodule: ``stft`` stays the function
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Package
