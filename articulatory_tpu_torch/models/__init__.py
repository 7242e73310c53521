"""Model registry: YAML class names -> the port's modules, the 17 classes of
the JAX package's registry (``articulatory_tpu/models/__init__.py``), by
``get_model_class(name)`` or built by ``build_model``.

``NOISE_DRIVEN_GENERATORS`` take ``(noise, aux)`` (the legacy collater's
batch), ``RNG_GENERATORS`` an explicit noise ``z``, and
``RNG_DISCRIMINATORS`` explicit random-window offsets: the port's training
step draws them from seeded ``torch.Generator``s where JAX draws from its
rng streams. ``DROPOUT_GENERATORS`` take the step's draws for their dropout
masks.
"""

from __future__ import annotations

import torch

from articulatory_tpu_torch.models.gblock_gen import GBlockGenerator
from articulatory_tpu_torch.models.hifigan import (
    HiFiGANGenerator,
    HiFiGANMultiPeriodDiscriminator,
    HiFiGANMultiScaleDiscriminator,
    HiFiGANMultiScaleMultiPeriodDiscriminator,
    HiFiGANPeriodDiscriminator,
    HiFiGANScaleDiscriminator,
)
from articulatory_tpu_torch.models.melgan import (
    MelGANDiscriminator,
    MelGANGenerator,
    MelGANMultiScaleDiscriminator,
)
from articulatory_tpu_torch.models.parallel_wavegan import (
    ParallelWaveGANDiscriminator,
    ParallelWaveGANGenerator,
    ResidualParallelWaveGANDiscriminator,
)
from articulatory_tpu_torch.models.rnn import BiGRU
from articulatory_tpu_torch.models.style_melgan import (
    StyleMelGANDiscriminator,
    StyleMelGANGenerator,
)
from articulatory_tpu_torch.models.transformer import Transformer

_REGISTRY = {cls.__name__: cls for cls in (
    HiFiGANGenerator, HiFiGANPeriodDiscriminator,
    HiFiGANMultiPeriodDiscriminator, HiFiGANScaleDiscriminator,
    HiFiGANMultiScaleDiscriminator,
    HiFiGANMultiScaleMultiPeriodDiscriminator, MelGANGenerator, MelGANDiscriminator, MelGANMultiScaleDiscriminator,
    ParallelWaveGANGenerator, ParallelWaveGANDiscriminator,
    ResidualParallelWaveGANDiscriminator, StyleMelGANGenerator,
    StyleMelGANDiscriminator, GBlockGenerator, BiGRU, Transformer)}
# every class of the registry: none reads a per-modality input list
MODEL_CLASSES = tuple(_REGISTRY.values())

# generators whose forward signature is (noise, aux) rather than (aux, ...)
NOISE_DRIVEN_GENERATORS = {"ParallelWaveGANGenerator"}
# generators that take an explicit noise z
RNG_GENERATORS = {"StyleMelGANGenerator"}
# generators that draw their dropout masks from the step's draws by tag
DROPOUT_GENERATORS = {"Transformer"}
# discriminators that take explicit random-window offsets
RNG_DISCRIMINATORS = {"StyleMelGANDiscriminator"}
_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "f32": torch.float32, "fp32": torch.float32,
           "float32": torch.float32}


def get_model_class(name: str):
    """The registered class of a YAML class name."""
    if name not in _REGISTRY:
        raise KeyError(f"Unknown model type: {name!r}. Known: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def build_model(name: str, params: dict | None, seed: int = 0):
    """Instantiate a registered model from YAML kwargs (lists -> tuples;
    ``compute_dtype`` strings like "bfloat16" -> torch dtypes). ``seed``
    seeds the initial weights."""
    cls = get_model_class(name)

    def freeze(k, v):
        if isinstance(v, list):
            return tuple(freeze(k, x) for x in v)
        if k == "compute_dtype" and isinstance(v, str):
            if v not in _DTYPES:
                raise ValueError(f"unsupported compute_dtype {v!r}")
            return _DTYPES[v]
        if isinstance(v, dict):
            return {kk: freeze(kk, vv) for kk, vv in v.items()}
        return v

    kwargs = {k: freeze(k, v) for k, v in dict(params or {}).items()}
    return cls(**kwargs, seed=seed)
