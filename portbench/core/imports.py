"""The check that nothing of JAX or the JAX package is loaded: top-level
module names compared whole (the port, ``articulatory_tpu_torch``, begins
with the JAX package's name and is not it)."""

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "articulatory_tpu"})


def forbidden_loaded() -> list[str]:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & FORBIDDEN)
