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

``generator_state_dict`` / ``discriminator_state_dict`` turn either
payload's model entries into the port's state dicts, for every generator
and discriminator of the zoo (a JAX ``BiGRU`` or ``Transformer`` with its
BatchNorm statistics from ``payload["mutables"]``; a cascade's
``generator2``, which the reference saves as a 1-tuple). ``save_checkpoint``
writes a training state as a torch pickle in the reference's layout,
``{"model": {"generator", "discriminator"[, "generator2"]}, "optimizer":
{...}, "scheduler": {...}, "steps", "epochs"}``, which ``load_model``
decodes from and ``restore_state`` resumes from, as it resumes a JAX
checkpoint: its optax Adam / AdamW moments go through the same layout map
as the weights (``optax_moments``). Orbax checkpoint directories are not
read by the port.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from articulatory_tpu_torch.train.optimizers import load_optax_state
from articulatory_tpu_torch.utils.weights import (
    discriminator_to_state_dict,
    generator_to_state_dict,
)

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
                         generator_params: dict,
                         generator_type: str = "HiFiGANGenerator"
                         ) -> dict[str, torch.Tensor]:
    """The port's state dict for ``payload["model"][generator_key]``: a JAX
    param tree is converted (a ``BiGRU``'s or ``Transformer``'s with
    ``payload["mutables"][generator_key]``), a torch state dict is used as
    it is."""
    sd: Any = payload["model"][generator_key]
    if isinstance(sd, tuple):  # reference generator2 save quirk (train.py:165)
        sd = sd[0]
    if _is_jax_tree(sd):
        mutables = (payload.get("mutables") or {}).get(generator_key) or {}
        return generator_to_state_dict(generator_type, sd, mutables,
                                       generator_params,
                                       int(payload.get("steps", 0)))
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def _is_jax_tree(sd: dict) -> bool:
    return any(isinstance(v, dict) for v in sd.values())


def discriminator_state_dict(payload: dict, discriminator_type: str,
                             discriminator_params: dict
                             ) -> dict[str, torch.Tensor]:
    """The port's state dict for ``payload["model"]["discriminator"]``: a
    JAX param tree is converted, a torch state dict used as it is."""
    sd: Any = payload["model"]["discriminator"]
    if not _is_jax_tree(sd):
        return {k: torch.as_tensor(v) for k, v in sd.items()}
    return discriminator_to_state_dict(discriminator_type, sd,
                                       discriminator_params)


def _cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, state, schedulers: dict | None = None,
                    epochs: int = 0) -> None:
    """Write a ``train/gan.py::GANTrainState`` (and the host schedulers) as
    one torch pickle, atomically."""
    model = {"generator": state.generator.state_dict(),
             "discriminator": state.discriminator.state_dict()}
    if getattr(state, "generator2", None) is not None:
        model["generator2"] = state.generator2.state_dict()
    payload = _cpu({
        "model": model,
        "optimizer": {"generator": state.opt_g.state_dict(),
                      "discriminator": state.opt_d.state_dict()},
        "scheduler": {k: v.state_dict() for k, v in (schedulers or {}).items()},
        "steps": int(state.steps),
        "epochs": int(epochs),
    })
    folder = os.path.dirname(path)
    if folder:
        os.makedirs(folder, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_state(state, payload: dict, config: dict,
                  schedulers: dict | None = None,
                  load_only_params: bool = False) -> int:
    """Load a checkpoint payload into ``state`` in place; returns epochs.

    ``load_only_params`` is ``--pretrain`` (the models' weights only, from a
    torch pickle or a JAX msgpack file); otherwise ``--resume`` (weights,
    optimizers, steps and schedulers, from a checkpoint the port wrote)."""
    state.generator.load_state_dict(generator_state_dict(
        payload, "generator", config["generator_params"],
        config["generator_type"]))
    state.discriminator.load_state_dict(discriminator_state_dict(
        payload, config["discriminator_type"],
        config.get("discriminator_params", {})))
    if "generator2" in payload["model"] and getattr(
            state, "generator2", None) is not None:
        state.generator2.load_state_dict(generator_state_dict(
            payload, "generator2", config["generator2_params"],
            config["generator2_type"]))
    if load_only_params:
        return 0
    for key, opt, model in (("generator", state.opt_g, state.generator),
                            ("discriminator", state.opt_d,
                             state.discriminator)):
        saved = payload["optimizer"][key]
        if _is_jax_tree(payload["model"][key]):
            load_optax_state(
                opt, config.get(f"{key}_optimizer_type", "RAdam"), saved,
                optax_moments(payload, key, config, model), model)
        else:
            opt.load_state_dict(saved)
    state.steps = int(payload.get("steps", 0))
    for k, v in payload.get("scheduler", {}).items():
        if schedulers and k in schedulers and v:
            schedulers[k].load_state_dict(
                {kk: (vv.item() if isinstance(vv, np.generic) else vv)
                 for kk, vv in v.items()})
    return int(payload.get("epochs", 0))


def _probe(tree, fill):
    """A tree of ``tree``'s shapes, each leaf ``fill(shape)``."""
    if isinstance(tree, dict):
        return {k: _probe(v, fill) for k, v in tree.items()}
    return fill(np.shape(tree))


def optax_moments(payload: dict, key: str, config: dict,
                  model: torch.nn.Module):
    """A map of a JAX moment tree of ``payload["model"][key]``'s layout
    (optax's ``mu`` or ``nu``) to ``{parameter name: tensor}`` of
    ``model``, through the converter of the weights. Adam is elementwise, so
    a converter that only moves elements (transposes, flips) maps the
    moments exactly; a parameter the converter computes otherwise (a
    weight norm folded from an effective weight) cannot carry them and
    raises, named, as does a parameter the converter does not give."""
    names = dict(model.named_parameters())

    def convert(tree) -> dict[str, torch.Tensor]:
        fake = dict(payload, model={key: tree})
        if key == "discriminator":
            sd = discriminator_state_dict(
                fake, config["discriminator_type"],
                config.get("discriminator_params", {}))
        else:
            sd = generator_state_dict(fake, key, config[f"{key}_params"],
                                      config[f"{key}_type"])
        return {k: v for k, v in sd.items() if k in names}

    params = payload["model"][key]
    ones = convert(_probe(params, np.ones))
    steps = convert(_probe(params, lambda shape: (
        np.arange(int(np.prod(shape))) % 7 + 1.0).reshape(shape)))
    both = convert(_probe(params, lambda shape: (
        np.arange(int(np.prod(shape))) % 7 + 2.0).reshape(shape)))
    missing = sorted(set(names) - set(ones))
    nonlinear = sorted(k for k in ones
                       if not torch.equal(ones[k] + steps[k], both[k]))
    if missing or nonlinear:
        raise NotImplementedError(
            f"the optax moments of the JAX {key} do not carry over to "
            f"{(missing + nonlinear)[:5]}: "
            + ("no JAX parameter maps onto them" if missing else
               "their converter is not a layout map"))
    return convert
