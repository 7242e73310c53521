"""Inference runtime: model loading, full-utterance synthesis and the
chunked-autoregressive decode loop (HiFi-CAR), ported from
``articulatory_tpu/inference.py`` for the a2w direction.

A chunk of ``batch_max_steps / hop_size`` feature frames and the last
``ar_input`` output samples (the AR carry) go through one generator forward;
the carry for the next chunk is the new output's tail (``ar_input <=
batch_max_steps``) or a shift register over several chunks (``ar_input >
batch_max_steps``), as in the reference's decode.py:77-81. Outputs stay on
the device until the loop ends.

``ar_loop_scan`` and ``ar_loop_batched(scan=True)`` are the counterpart of
the JAX package's one-dispatch ``lax.scan`` decode: on a card, one chunk
step (the forward and the carry update) is captured in a CUDA graph
(``ChunkGraph``) and replayed once a chunk, with the padded lane batch
uploaded once and one host sync at the end. On the CPU the same chunking,
bucketing and trimming run through the eager per-chunk loop, the graph's
plain version. On a card a capture or replay that fails raises; nothing
falls back to the eager loop.

Weights may be stored as int8 (``LoadedModel.quantize_int8``) or bfloat16
(``to_bf16_weights``); the kernels read the dequantized or upcast frozen
weights. Float64 inputs decode in float64 through ``ar_loop`` (with a
``.double()`` model), for parity checks.

Not ported yet (they raise ``NotImplementedError``): w2a inversion,
multimodal decode, PQMF synthesis.
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

WARMUP_STEPS = 2  # eager chunk steps on the capture stream before capture


@dataclasses.dataclass
class LoadedModel:
    model: nn.Module
    config: dict
    device: torch.device
    mean: np.ndarray | None = None
    scale: np.ndarray | None = None
    quantized: bool = False  # int8 weights (see quantize_int8)
    graphs: dict = dataclasses.field(default_factory=dict, repr=False)

    def normalize(self, c: np.ndarray) -> np.ndarray:
        if self.mean is None:
            return c
        return (c - self.mean) / self.scale

    def remove_weight_norm(self) -> None:
        """Freeze the kernels: each is derived from (g, v) once per dtype and
        cached; outputs are unchanged (reference API parity)."""
        self.model.remove_weight_norm()
        self.graphs.clear()

    def quantize_int8(self) -> None:
        """Fold weight norm and store the conv and dense weights as int8
        (symmetric per output channel, ``utils/quantize.py``); the frozen
        kernels are dequantized once and cached."""
        from articulatory_tpu_torch.utils.quantize import (
            fold_weight_norm_,
            quantize_int8_,
        )

        self.remove_weight_norm()
        fold_weight_norm_(self.model)
        quantize_int8_(self.model)
        self.quantized = True
        self.graphs.clear()

    def to_bf16_weights(self) -> None:
        """Fold weight norm and store every float parameter as bfloat16;
        compute dtypes stay as they are (f32 layers upcast the weights)."""
        if self.quantized:
            raise ValueError(
                "to_bf16_weights on an int8-quantized model would cast the "
                "dequantization scales to bf16 (silent extra rounding); "
                "pick one weight-compression scheme")
        from articulatory_tpu_torch.utils.quantize import fold_weight_norm_

        self.remove_weight_norm()
        fold_weight_norm_(self.model)
        self.model.to(torch.bfloat16)
        self.graphs.clear()

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

    def chunk_graph(self, batch: int, in_chunk_len: int, feat_dim: int,
                    past_out_len: int, out_channels: int,
                    last_window: bool) -> ChunkGraph:
        """The captured chunk step for this signature, captured on first
        use and cached (dropped when the weights change)."""
        gen = self.model
        key = (batch, in_chunk_len, feat_dim, past_out_len, out_channels,
               last_window, str(getattr(gen, "compute_dtype", None)),
               bool(getattr(gen, "hybrid_precision", False)))
        if key not in self.graphs:
            self.graphs[key] = ChunkGraph(gen, self.device, *key[:6])
        return self.graphs[key]

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
    raises without a card). ``weight_quant: int8`` stores the weights as
    int8."""
    dev = resolve_device(device)
    prefix = "generator2" if generator2 else "generator"
    if config is None:
        config = os.path.join(os.path.dirname(checkpoint), "config.yml")
    if isinstance(config, str):
        config = load_config(config)
    quant = config.get("weight_quant")
    if quant and quant != "int8":
        raise ValueError(f"unsupported weight_quant: {quant} (only 'int8' is "
                         "implemented)")
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
    loaded = LoadedModel(model=model, config=config, device=dev, mean=mean,
                         scale=scale)
    if quant:
        loaded.quantize_int8()
    return loaded


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


class ChunkGraph:
    """One chunk step of the batched AR loop captured in a CUDA graph: the
    generator forward on a static input ``(B, in_chunk_len, F)`` and carry
    ``(B, P, C_out)``, then the carry update written back into the static
    carry. ``WARMUP_STEPS`` eager steps on the capture stream come first,
    so that every first-use host step of the kernels (shared-memory
    attributes, launch plans, tensor maps, the f32 weight splits cached on
    the frozen kernels) happens outside the capture. The graph keeps the
    frozen kernels it reads alive."""

    @torch.inference_mode()
    def __init__(self, model: nn.Module, device: torch.device, batch: int,
                 in_chunk_len: int, feat_dim: int, past_out_len: int,
                 out_channels: int, last_window: bool):
        self.static_in = torch.zeros((batch, in_chunk_len, feat_dim),
                                     device=device)
        self.static_prev = torch.zeros((batch, past_out_len, out_channels),
                                       device=device)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_STEPS):
                out = model(self.static_in, self.static_prev)
                _next_carry(self.static_prev, out, past_out_len, last_window)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                self.static_out = model(self.static_in, self.static_prev)
                # a fresh tensor first: the shift register reads the carry
                new_prev = _next_carry(self.static_prev, self.static_out,
                                       past_out_len, last_window)
                self.static_prev.copy_(new_prev)
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the chunk step (B {batch}, {in_chunk_len} frames "
                f"x {feat_dim}, carry {past_out_len}) in a CUDA graph "
                f"failed; on a card the scan decode runs only as a graph"
            ) from e
        self.weights = [t for m in model.modules()
                        for entry in (getattr(m, "_cache", None) or {}).values()
                        for t in entry if t is not None]

    @torch.inference_mode()
    def run(self, chunks: torch.Tensor) -> torch.Tensor:
        """chunks ``(n, B, in_chunk_len, F)`` on the card -> outputs ``(n, B,
        T_out, C_out)``, the carry starting from zeros."""
        outs = torch.empty((len(chunks), *self.static_out.shape),
                           dtype=self.static_out.dtype,
                           device=self.static_out.device)
        self.static_prev.zero_()
        for i in range(len(chunks)):
            self.static_in.copy_(chunks[i])
            self.graph.replay()
            outs[i].copy_(self.static_out)
        return outs


def _eager_chunks(model: LoadedModel, chunks: torch.Tensor,
                  past_out_len: int, out_channels: int,
                  last_window: bool) -> torch.Tensor:
    """The chunk loop eagerly: chunks ``(n, B, T, F)`` -> ``(B, n * T_out,
    C_out)``."""
    prev = torch.zeros((chunks.shape[1], past_out_len, out_channels),
                       device=model.device)
    outs = []
    for cin in chunks:
        cout = model(cin, ar=prev)
        outs.append(cout)
        prev = _next_carry(prev, cout, past_out_len, last_window)
    return torch.cat(outs, dim=1)


def _scan_chunks(model: LoadedModel, chunks: np.ndarray, past_out_len: int,
                 out_channels: int, last_window: bool) -> np.ndarray:
    """chunks ``(n, B, T, F)`` -> ``(B, n * T_out, C_out)``: one upload, the
    captured chunk step replayed once a chunk on a card (the eager loop on
    the CPU), one host sync."""
    dev_chunks = torch.from_numpy(np.ascontiguousarray(chunks)).to(
        model.device)
    if model.device.type == "cpu":
        return _eager_chunks(model, dev_chunks, past_out_len, out_channels,
                             last_window).numpy()
    n, b, in_chunk_len, feat_dim = chunks.shape
    graph = model.chunk_graph(b, in_chunk_len, feat_dim, past_out_len,
                              out_channels, last_window)
    outs = graph.run(dev_chunks)  # (n, B, T_out, C)
    return outs.transpose(0, 1).reshape(b, -1, outs.shape[-1]).cpu().numpy()


def ar_loop(model: LoadedModel, x: np.ndarray, config: dict,
            do_wsola: bool = False, modality: int | None = None,
            generator2: bool = False):
    """Chunked AR decode of one utterance (reference decode.py:31-100).
    x: (T, num_feats) features -> waveform (T * hop,) (or (T * hop, C_out)).
    float64 features decode in float64 (the model must be float64 too).
    ``do_wsola``: 50 %-overlap windows instead, -> (list of each window's
    waveform, list of its input frames)."""
    if modality is not None:
        raise NotImplementedError("multimodal decode is not ported yet")
    params_key = "generator2_params" if generator2 else "generator_params"
    in_chunk_len, past_out_len, out_channels = _a2w_chunking(config, params_key)
    x = np.asarray(x)
    # float64 kept for parity decodes; everything else computes in float32
    x = x if x.dtype == np.float64 else x.astype(np.float32)
    if x.ndim == 1:
        x = x[:, None]
    if do_wsola:
        return _wsola(model, x, config, params_key, in_chunk_len, past_out_len)
    last_window = past_out_len <= config["batch_max_steps"]
    prev = torch.zeros((1, past_out_len, out_channels),
                       dtype=torch.float64 if x.dtype == np.float64
                       else torch.float32, device=model.device)
    outs = []
    for i in range(0, len(x), in_chunk_len):
        cout = model(x[None, i:i + in_chunk_len], ar=prev)
        outs.append(cout[0])
        prev = _next_carry(prev, cout, past_out_len, last_window)
    out = torch.cat(outs, dim=0).cpu().numpy()
    return out[:, 0] if out.shape[1] == 1 else out


def _wsola(model: LoadedModel, x: np.ndarray, config: dict, params_key: str,
           in_chunk_len: int, past_out_len: int):
    """WSOLA decode (JAX ``ar_loop(do_wsola=True)``): windows of
    ``in_chunk_len`` frames (+1 with ``extra_art``) every half chunk; each
    window's carry is the previous output's samples just before its middle."""
    if in_chunk_len % 2:
        raise ValueError(f"WSOLA needs an even chunk length, got "
                         f"{in_chunk_len} frames")
    extra = int(bool(config[params_key].get("extra_art", False)))
    step = in_chunk_len // 2
    ins = [x[i:i + in_chunk_len + extra] for i in range(0, len(x), step)]
    half = config["batch_max_steps"] // 2
    prev = torch.zeros((1, past_out_len, 1), device=model.device)
    outs = []
    for i, art in enumerate(ins):
        signal = model(art[None], ar=prev)  # (1, T, 1)
        outs.append(signal[0, :, 0].cpu().numpy())
        if i < len(ins) - 1:
            prev = signal[:, half - past_out_len:half, :]
            if prev.shape[1] != past_out_len:
                raise ValueError(f"WSOLA needs ar_input {past_out_len} <= "
                                 f"half a chunk ({half} samples)")
    return outs, ins


def ar_loop_batched(model: LoadedModel, xs: list[np.ndarray], config: dict,
                    scan: bool = False) -> list[np.ndarray]:
    """Throughput-mode chunked AR decode over a batch of utterances.

    Each utterance keeps its own AR carry; inputs are zero-padded to a common
    chunk count and outputs trimmed to each utterance's length. Outputs match
    the sequential ``ar_loop`` on every complete chunk. ``scan=True`` runs
    the same lane semantics through the captured chunk step (one upload, one
    replay a chunk, one host sync; the eager loop on the CPU)."""
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
    chunks = batch.reshape(b, n_chunks, in_chunk_len, feat_dim).swapaxes(0, 1)
    if scan:
        wav = _scan_chunks(model, chunks, past_out_len, out_channels,
                           last_window)
    else:
        wav = _eager_chunks(model, torch.from_numpy(
            np.ascontiguousarray(chunks)).to(model.device), past_out_len,
            out_channels, last_window).cpu().numpy()
    return [wav[i, : lengths[i] * hop, 0] if out_channels == 1
            else wav[i, : lengths[i] * hop] for i in range(b)]


def ar_loop_scan(model: LoadedModel, x: np.ndarray, config: dict,
                 chunk_bucket: int = 0) -> np.ndarray:
    """One utterance through the captured chunk step (JAX
    ``ar_loop_scan``, a2w): pad to whole chunks, run them all, trim to
    ``T * hop``. A ragged last chunk is computed under zero padding, as in
    the JAX package; near its end it differs from ``ar_loop``'s short
    chunk, whose padding carries no tiled AR features. ``chunk_bucket``
    rounds the chunk count up to a multiple (the padded chunks are computed
    and dropped); 0 = exact."""
    in_chunk_len, past_out_len, out_channels = _a2w_chunking(
        config, "generator_params")
    hop = config["hop_size"]
    last_window = past_out_len <= config["batch_max_steps"]
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    t = len(x)
    n_chunks = max(-(-t // in_chunk_len), 1)
    if chunk_bucket:
        n_chunks = -(-n_chunks // chunk_bucket) * chunk_bucket
    xp = np.pad(x, ((0, n_chunks * in_chunk_len - t), (0, 0)))
    chunks = xp.reshape(n_chunks, 1, in_chunk_len, x.shape[1])
    out = _scan_chunks(model, chunks, past_out_len, out_channels,
                       last_window)[0]
    return out[: t * hop, 0] if out.shape[1] == 1 else out[: t * hop]
