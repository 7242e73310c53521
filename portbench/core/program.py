"""The system under test, ``articulatory_tpu_torch``, set up as its entry
points set it up, with weights that the benchmark made.

The weights are a state dict under the recipe's torch names, drawn on the
card from the seed (``seeds.make_weights``) from the shapes the reference
gives; the port loads them with ``load_state_dict(strict=True)``, so a
port whose parameters differ from the reference's in name or shape fails
here. The same dict, which the port does not hold, goes to the reference.
"""

from __future__ import annotations

import torch

from portbench.core import seeds
from portbench.reference.discriminators import discriminator_shapes
from portbench.reference.hifigan import generator_shapes


# the past encoder's layers drawn He-uniform, U(+-sqrt(6 / fan_in)): with
# torch's default bound five LeakyReLU layers shrink the carry ~15x, and
# the AR features would barely reach the output
AR_GAINS = {"ar_model.": 6 ** 0.5}


def device(kind: str) -> torch.device:
    """The port's device resolution (on a card it turns TF32 off, as every
    entry point of the port does)."""
    from articulatory_tpu_torch.utils.device import resolve_device
    return resolve_device(kind)


def _loaded(module: torch.nn.Module, weights: dict, dev) -> torch.nn.Module:
    module.to(dev)
    module.load_state_dict(weights, strict=True)
    return module


def generator(model: dict, seed: int, dev) -> tuple[torch.nn.Module, dict]:
    """(the port's generator with the seed's weights, the weights)."""
    from articulatory_tpu_torch.models import build_model
    gp = model["generator_params"]
    weights = seeds.make_weights(generator_shapes(gp), seed, dev,
                                 "generator", AR_GAINS)
    return _loaded(build_model(model["generator_type"], gp), weights,
                   dev), weights


def discriminator(model: dict, seed: int, dev
                  ) -> tuple[torch.nn.Module, dict]:
    from articulatory_tpu_torch.models import build_model
    dp = model["discriminator_params"]
    weights = seeds.make_weights(discriminator_shapes(dp), seed, dev,
                                 "discriminator")
    return _loaded(build_model(model["discriminator_type"], dp), weights,
                   dev), weights


def decoder(model: dict, seed: int, dev):
    """(the port's ``LoadedModel`` as ``bin/decode.py`` makes it: eval mode,
    weight norm removed, the weights)."""
    from articulatory_tpu_torch.inference import LoadedModel
    gen, weights = generator(model, seed, dev)
    loaded = LoadedModel(model=gen.eval(), config=model, device=dev)
    loaded.remove_weight_norm()
    return loaded, weights
