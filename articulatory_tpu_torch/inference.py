"""Inference runtime: model loading, full-utterance synthesis and the
chunked-autoregressive decode loop (HiFi-CAR), ported from
``articulatory_tpu/inference.py`` for the a2w direction.

A chunk of ``batch_max_steps / hop_size`` feature frames and the last
``ar_input`` output samples (the AR carry) go through one generator forward;
the carry for the next chunk is the new output's tail (``ar_input <=
batch_max_steps``) or a shift register over several chunks (``ar_input >
batch_max_steps``), as in the reference's decode.py:77-81. Outputs stay on
the device until the loop ends.

Not ported yet (they raise ``NotImplementedError``): w2a inversion, WSOLA,
multimodal decode, the one-dispatch scan decode, int8 weights, PQMF
synthesis.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch import nn

from articulatory_tpu_torch.config import fix_generator_params, load_config
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.utils.checkpoint import (
    generator_state_dict,
    load_checkpoint,
)
from articulatory_tpu_torch.utils.device import resolve_device
from articulatory_tpu_torch.utils.io import read_hdf5


@dataclasses.dataclass
class LoadedModel:
    model: nn.Module
    config: dict
    device: torch.device
    mean: np.ndarray | None = None
    scale: np.ndarray | None = None

    def normalize(self, c: np.ndarray) -> np.ndarray:
        if self.mean is None:
            return c
        return (c - self.mean) / self.scale

    def remove_weight_norm(self) -> None:
        """Freeze the kernels: each is derived from (g, v) once per dtype and
        cached; outputs are unchanged (reference API parity)."""
        self.model.remove_weight_norm()

    @torch.inference_mode()
    def __call__(self, c, ar=None) -> torch.Tensor:
        """(B, T, C) features [and (B, P, 1) AR carry] -> (B, T_out, C_out)
        on the model's device."""
        c = torch.as_tensor(c, device=self.device)
        if c.is_floating_point() and c.dtype != torch.float64:
            c = c.float()
        if ar is None:
            return self.model(c)
        return self.model(c, torch.as_tensor(ar, device=self.device,
                                             dtype=c.dtype))

    def inference(self, c: np.ndarray, normalize_before: bool = False,
                  bucket_frames: int | None = None) -> np.ndarray:
        """(T, in_feats) -> (T * prod(scales), out_channels), full utterance.

        ``bucket_frames`` pads T up to a multiple before the forward and trims
        the output back, as the JAX package does to bound its compile count;
        only the last receptive-field window can differ from an exact-length
        forward."""
        c = np.asarray(c, np.float32)
        if normalize_before:
            c = self.normalize(c)
        t = c.shape[0]
        if bucket_frames:
            pad = (-t) % bucket_frames
            if pad:
                c = np.pad(c, [(0, pad)] + [(0, 0)] * (c.ndim - 1))
        out = self(c[None])[0].cpu().numpy()
        if bucket_frames:
            out = out[: out.shape[0] * t // c.shape[0]]
        return out


def _load_stats(stats: str) -> tuple[np.ndarray, np.ndarray]:
    if stats.endswith(".h5"):
        return (read_hdf5(stats, "mean").reshape(-1),
                read_hdf5(stats, "scale").reshape(-1))
    arr = np.load(stats)
    return arr[0].reshape(-1), arr[1].reshape(-1)


def load_model(checkpoint: str, config: dict | str | None = None,
               stats: str | None = None, generator2: bool = False,
               device: str | torch.device | None = None) -> LoadedModel:
    """Rebuild a generator from its config and a checkpoint (a JAX-package
    msgpack file or a reference torch pickle) on ``device`` (default cuda;
    raises without a card)."""
    dev = resolve_device(device)
    prefix = "generator2" if generator2 else "generator"
    if config is None:
        config = os.path.join(os.path.dirname(checkpoint), "config.yml")
    if isinstance(config, str):
        config = load_config(config)
    if config.get("weight_quant"):
        raise NotImplementedError("weight_quant is not ported yet")
    gen_type = config.get(f"{prefix}_type", "ParallelWaveGANGenerator")
    gen_params = fix_generator_params(config[f"{prefix}_params"])
    if gen_params.get("out_channels", 1) > 1 and config.get("pqmf", False):
        raise NotImplementedError("PQMF synthesis is not ported yet")
    model = build_model(gen_type, gen_params)
    model.load_state_dict(generator_state_dict(load_checkpoint(checkpoint),
                                               prefix, gen_params))
    model.to(dev).eval()

    if stats is None:  # stats beside the checkpoint (reference utils.py:345)
        ext = "h5" if config.get("format", "hdf5") == "hdf5" else "npy"
        candidate = os.path.join(os.path.dirname(checkpoint), f"stats.{ext}")
        if os.path.exists(candidate):
            stats = candidate
    mean = scale = None
    if stats is not None:
        mean, scale = _load_stats(stats)
    return LoadedModel(model=model, config=config, device=dev, mean=mean,
                       scale=scale)


def _a2w_chunking(config: dict, params_key: str) -> tuple[int, int, int]:
    """(input frames per chunk, AR carry length, output channels)."""
    if config.get("dataset_mode") == "w2a":
        raise NotImplementedError("w2a (inversion) decode is not ported yet")
    gp = config[params_key]
    return (int(config["batch_max_steps"] / config["hop_size"]),
            gp.get("ar_input", 512), gp.get("out_channels", 1))


def _next_carry(prev: torch.Tensor, cout: torch.Tensor, past_out_len: int,
                last_window: bool) -> torch.Tensor:
    if last_window:
        return cout[:, -past_out_len:, :]
    # shift register (reference decode.py:79-81): the AR window spans
    # several chunks; slide left by one chunk's output
    return torch.cat([prev[:, cout.shape[1]:, :], cout], dim=1)


def ar_loop(model: LoadedModel, x: np.ndarray, config: dict,
            do_wsola: bool = False, modality: int | None = None,
            generator2: bool = False) -> np.ndarray:
    """Chunked AR decode of one utterance (reference decode.py:31-100).
    x: (T, num_feats) features -> waveform (T * hop,) (or (T * hop, C_out))."""
    if do_wsola or modality is not None:
        raise NotImplementedError("WSOLA and multimodal decode are not "
                                  "ported yet")
    params_key = "generator2_params" if generator2 else "generator_params"
    in_chunk_len, past_out_len, out_channels = _a2w_chunking(config, params_key)
    last_window = past_out_len <= config["batch_max_steps"]
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    prev = torch.zeros((1, past_out_len, out_channels), device=model.device)
    outs = []
    for i in range(0, len(x), in_chunk_len):
        cout = model(x[None, i:i + in_chunk_len], ar=prev)
        outs.append(cout[0])
        prev = _next_carry(prev, cout, past_out_len, last_window)
    out = torch.cat(outs, dim=0).cpu().numpy()
    return out[:, 0] if out.shape[1] == 1 else out


def ar_loop_batched(model: LoadedModel, xs: list[np.ndarray], config: dict,
                    scan: bool = False) -> list[np.ndarray]:
    """Throughput-mode chunked AR decode over a batch of utterances.

    Each utterance keeps its own AR carry; inputs are zero-padded to a common
    chunk count and outputs trimmed to each utterance's length. Outputs match
    the sequential ``ar_loop`` on every complete chunk."""
    if scan:
        raise NotImplementedError("the one-dispatch scan decode is not "
                                  "ported yet")
    in_chunk_len, past_out_len, out_channels = _a2w_chunking(
        config, "generator_params")
    hop = config["hop_size"]
    last_window = past_out_len <= config["batch_max_steps"]
    b = len(xs)
    lengths = [len(x) for x in xs]
    n_chunks = max(-(-t // in_chunk_len) for t in lengths)
    if n_chunks == 0:
        return [np.zeros((0,), np.float32) if out_channels == 1
                else np.zeros((0, out_channels), np.float32) for _ in xs]
    feat_dim = xs[0].shape[1] if xs[0].ndim == 2 else 1
    batch = np.zeros((b, n_chunks * in_chunk_len, feat_dim), np.float32)
    for i, x in enumerate(xs):
        batch[i, : lengths[i]] = np.asarray(x, np.float32).reshape(
            lengths[i], feat_dim)
    batch = torch.from_numpy(batch).to(model.device)

    prev = torch.zeros((b, past_out_len, out_channels), device=model.device)
    outs = []
    for ci in range(n_chunks):
        cout = model(batch[:, ci * in_chunk_len:(ci + 1) * in_chunk_len],
                     ar=prev)
        outs.append(cout)
        prev = _next_carry(prev, cout, past_out_len, last_window)
    wav = torch.cat(outs, dim=1).cpu().numpy()
    return [wav[i, : lengths[i] * hop, 0] if out_channels == 1
            else wav[i, : lengths[i] * hop] for i in range(b)]
