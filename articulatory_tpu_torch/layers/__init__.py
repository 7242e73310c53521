"""The layers the JAX package's ``articulatory_tpu/layers/__init__.py``
exports, each resolved on first use (``stretch_time`` is the port's
``residual.nearest_upsample``), so importing a module of this package
costs nothing more."""

import importlib

_NAMES = {
    **{name: ("conv", name) for name in (
        "Conv1d", "ConvTranspose1d", "Conv2d", "Dense", "Embed",
        "CausalConv1d", "CausalConvTranspose1d")},
    **{name: ("residual", name) for name in (
        "HiFiGANResidualBlock", "WaveNetResidualBlock",
        "MelGANResidualStack", "ResBlock", "GBlock")},
    "PastFCEncoder": ("past_encoder", "PastFCEncoder"),
    "PastSeqEncoder": ("past_encoder", "PastSeqEncoder"),
    "UpsampleNetwork": ("upsample", "UpsampleNetwork"),
    "ConvInUpsampleNetwork": ("upsample", "ConvInUpsampleNetwork"),
    "stretch_time": ("residual", "nearest_upsample"),
    "TADELayer": ("tade", "TADELayer"),
    "TADEResBlock": ("tade", "TADEResBlock"),
    "TransformerEncoderLayer": ("transformer", "TransformerEncoderLayer"),
    "MultiHeadAttention": ("transformer", "MultiHeadAttention"),
    "get_activation": ("activations", "get_activation"),
}

__all__ = list(_NAMES)


def __getattr__(name):
    if name in _NAMES:
        module, attr = _NAMES[name]
        return getattr(importlib.import_module(f"{__name__}.{module}"), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
