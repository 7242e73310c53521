"""Model export for deployment outside this package's Python (port of
``articulatory_tpu/export.py``).

``to_torch_export`` is the counterpart of the JAX package's
``to_stablehlo``: a generator forward traced by ``torch.export`` at the
example inputs' static shapes into an ``ExportedProgram``; a tuple output (a
phoneme head's logits beside the waveform) gives its first element, as
there. The HiFi-GAN residual pairs stay in the graph as the registered op
``articulatory_tpu_torch::resblock_pair`` (``ops/resblock_pair.py``), one
node a pair, so a program exported from a model on a card launches the hand
kernel when it runs; on the CPU the op runs the plain pair. ``serialize``
and ``deserialize`` carry a program as bytes (``torch.export.save`` /
``load``); a process that loads one must import this module (or
``ops/resblock_pair.py``) first, which registers the op.

A model with frozen kernels (``remove_weight_norm``) runs once on the
example inputs first, which derives them (``layers/conv.py::_Stored``);
the program holds them as constants, as JAX's export closes over its
variables, instead of deriving them from the parameters in every forward
(``_Stored.lifted``: buffers of the traced root, so that the loaded
program fetches each in one lookup, not through the module path), and
the pair caches its f32 weight split on them (``ops/resblock_pair.py::
CONSTANT``), as the eager decode does. The JAX package's ``to_tf_module``
needs TensorFlow and is not ported.

    ep = to_torch_export(model, (c, ar))
    blob = serialize(ep)
    y = deserialize(blob).module()(c, ar)
"""

from __future__ import annotations

import contextlib
import io

import torch
from torch import nn

from articulatory_tpu_torch.layers.conv import _Stored
# registers the op a program holds
from articulatory_tpu_torch.ops import resblock_pair as _pair

PAIR_OP = _pair._OP


class _Forward(nn.Module):
    """``model(*inputs, **forward_kwargs)``, the first element of a tuple
    output."""

    def __init__(self, model: nn.Module, forward_kwargs: dict):
        super().__init__()
        self.model = model
        self.forward_kwargs = forward_kwargs

    def forward(self, *inputs):
        out = self.model(*inputs, **self.forward_kwargs)
        return out[0] if isinstance(out, tuple) else out


def to_torch_export(model: nn.Module, example_inputs: tuple,
                    **forward_kwargs) -> torch.export.ExportedProgram:
    """Trace ``model``'s forward at ``example_inputs``' shapes, dtypes and
    device into an ``ExportedProgram``; ``forward_kwargs`` are passed to
    every call as constants. A model with frozen kernels runs once first,
    which derives them, and the program holds them as constants."""
    forward = _Forward(model, forward_kwargs)
    frozen = [m for m in model.modules()
              if isinstance(m, _Stored) and m._frozen is not None]
    with torch.no_grad(), contextlib.ExitStack() as stack:
        if frozen:
            forward(*example_inputs)
        for i, m in enumerate(frozen):
            stack.enter_context(m.lifted(forward, f"frozen_{i}"))
        ep = torch.export.export(forward, tuple(example_inputs), strict=False)
    return _marked(ep)


def _marked(ep: torch.export.ExportedProgram) -> torch.export.ExportedProgram:
    """``ep`` with its constant tensors flagged as such, for the pair's
    split cache."""
    for value in ep.constants.values():
        if isinstance(value, torch.Tensor):
            setattr(value, _pair.CONSTANT, True)
    return ep


def pair_nodes(ep: torch.export.ExportedProgram) -> int:
    """The residual-pair op nodes of ``ep``'s graph."""
    return sum(1 for node in ep.graph.nodes
               if node.op == "call_function" and node.target == PAIR_OP)


def serialize(ep: torch.export.ExportedProgram) -> bytes:
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def deserialize(blob: bytes) -> torch.export.ExportedProgram:
    return _marked(torch.export.load(io.BytesIO(blob)))
