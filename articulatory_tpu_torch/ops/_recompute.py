"""Backward by recomputation, for the kernels that have no backward kernel.

The JAX package has no backward kernel for either TPU kernel. The scale
discriminator head's ``autograd.Function`` (both devices) and the residual
pair's in bfloat16 on the card (the hybrid's stages) recompute their plain
PyTorch version under autograd from the saved inputs and differentiate
that; the f32 pair has its own backward kernels, and a CPU pair its plain
gradients (``ops/resblock_pair.py``). It costs one extra plain forward and
keeps no intermediate activation between forward and backward. Each
recomputation is a span ``recompute_grads:<plain's name>`` (``trace.py``),
so a profiled step can attribute the kernels it launches.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from articulatory_tpu_torch.trace import span

RANGE = "recompute_grads"


def recompute_grads(plain: Callable, saved: Sequence[torch.Tensor | None],
                    needs: Sequence[bool], grads, **kwargs) -> list:
    """Gradients of ``plain(*saved, **kwargs)`` weighted by ``grads`` (one
    per output) for each input whose entry of ``needs`` is set; None for
    the others."""
    inputs = [None if t is None else t.detach().requires_grad_(need)
              for t, need in zip(saved, needs)]
    wrt = [t for t, need in zip(inputs, needs) if need and t is not None]
    with span(f"{RANGE}:{plain.__name__}"):
        with torch.enable_grad():
            outputs = plain(*inputs, **kwargs)
        found = iter(torch.autograd.grad(outputs, wrt, grads) if wrt else ())
    return [next(found) if need and t is not None else None
            for t, need in zip(inputs, needs)]
