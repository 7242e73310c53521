"""Read the JAX package's checkpoints and reference torch pickles.

- flax msgpack files (``articulatory_tpu/utils/checkpoint.py``): a msgpack
  map whose arrays are ext type 1 carrying ``(shape, dtype name, C-order
  bytes)`` (ext type 3 is a numpy scalar in the same encoding); arrays above
  flax's chunk size are stored as ``{"__msgpack_chunked_array__": True,
  "shape": ..., "chunks": ...}``. ``msgpack`` is imported only here.
- torch pickles (zip files, or legacy pickles starting with the pickle
  protocol opcode), read with ``torch.load(weights_only=True)``. The format
  is told from the first bytes, not the name: the JAX package writes msgpack
  under ``.pkl`` names too.

``generator_state_dict`` turns either payload's generator entry into the
port's state dict. Orbax checkpoint directories are not read by the port.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from articulatory_tpu_torch.utils.weights import jax_params_to_state_dict

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        raw = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16)
        return raw.float().numpy().reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape, order="C")


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _indexed(d: dict) -> list:
    return [d[str(i)] for i in range(len(d))]


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get("__msgpack_chunked_array__"):
            shape = tuple(_indexed(tree["shape"]))
            return np.concatenate(_indexed(tree["chunks"])).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def load_msgpack(path: str) -> dict:
    """A flax ``msgpack_serialize`` file -> nested dicts of numpy arrays."""
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(tree)


def _is_torch_pickle(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(2)
    # a msgpack payload is a non-empty map, so it never starts with 0x80
    return head == b"PK" or (len(head) == 2 and head[0] == 0x80
                             and 2 <= head[1] <= 5)


def load_checkpoint(path: str) -> dict:
    """Checkpoint payload ``{"model": {"generator": ...}, ...}`` from a flax
    msgpack file or a torch pickle."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint); the port reads "
            "msgpack files and torch pickles only")
    if _is_torch_pickle(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    return load_msgpack(path)


def generator_state_dict(payload: dict, generator_key: str,
                         generator_params: dict) -> dict[str, torch.Tensor]:
    """The port's state dict for ``payload["model"][generator_key]``: a JAX
    param tree is converted, a torch state dict is used as it is."""
    sd: Any = payload["model"][generator_key]
    if isinstance(sd, tuple):  # reference generator2 save quirk (train.py:165)
        sd = sd[0]
    if any(isinstance(v, dict) for v in sd.values()):
        return jax_params_to_state_dict(sd, generator_params)
    return {k: torch.as_tensor(v) for k, v in sd.items()}
