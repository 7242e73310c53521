"""Inference runtime: model loading, full-utterance synthesis or inversion
and the chunked-autoregressive decode loop (HiFi-CAR), ported from
``articulatory_tpu/inference.py`` for both directions.

a2w (features -> waveform): a chunk of ``batch_max_steps / hop_size``
feature frames and the last ``ar_input`` output samples (the AR carry) go
through one generator forward. w2a (``dataset_mode: w2a``, acoustic
features -> EMA trajectories through a ``BiGRU``): a chunk is
``batch_max_steps`` input rows and the carry holds the last ``ar_input /
out_channels`` output frames; a trailing chunk shorter than ``hop_size``
rows is dropped (reference decode.py:57-58). In both, the carry for the
next chunk is the new output's tail when it is at most ``batch_max_steps``
long, else a shift register over several chunks that slides by the output
length (a2w) or the input rows (w2a), as in the reference's
decode.py:77-81. Outputs stay on the device until the loop ends.

``ar_loop_scan`` and ``ar_loop_batched(scan=True)`` are the counterpart of
the JAX package's one-dispatch ``lax.scan`` decode: on a card, one chunk
step (the forward and the carry update) is captured in a CUDA graph
(``ChunkGraph``) and replayed once a chunk, with the padded lane batch
uploaded once and one host sync at the end. On the CPU the same chunking,
bucketing and trimming run through the eager per-chunk loop, the graph's
plain version. On a card a capture or replay that fails raises; nothing
falls back to the eager loop. A w2a ragged tail runs after the whole chunks
as one exact-shape forward, as in the JAX package.

Weights of any model may be stored as int8 (``LoadedModel.quantize_int8``)
or bfloat16 (``to_bf16_weights``); the layers and kernels read the
dequantized or upcast frozen weights. Float64 inputs decode in float64 through ``ar_loop`` (with a
``.double()`` model), for parity checks.

Every generator of the zoo decodes full utterances through
``LoadedModel.inference``: a multi-band model (``out_channels > 1`` and
``pqmf: true``, the JAX package's gate; a w2a model's channels are
features, not sub-bands) is synthesised by ``ops/pqmf.py``; Parallel
WaveGAN and StyleMelGAN draw their noise from the ``LoadedModel``'s
``torch.Generator`` (seeded 0) through their ``inference`` methods.
The chunked-AR loops run the AR generators (``use_ar``), as in the JAX
package, whose ``ar_loop`` never applies PQMF.

A generator with a phoneme head (``use_ph_loss``) decodes like any other:
every forward of ``LoadedModel`` and of the captured chunk step keeps its
waveform and drops the phoneme logits, as the JAX package's ``LoadedModel``
does. As there, the loops pass no speaker or phoneme ids: a generator
conditioned on them (``use_spk_id``, ``use_ph``) does not decode through
them. ``load_model(generator2=True)`` loads a cascade's second stage.

The multimodal decode (``ar_loop(modality=m)``, the ``a2w_mult`` mode):
each chunk of modality ``m``'s frames is linearly interpolated onto the
common frame rate (``ops/interp.py``) and handed to the model as the
``m``-th entry of a per-modality list (``None`` elsewhere), an ``in_list``
model's input; the carry moves as in the plain loop. No model of the
registry reads such a list, in the JAX package or here.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch import nn

from articulatory_tpu_torch.config import fix_generator_params, load_config
from articulatory_tpu_torch.models import (
    MODEL_CLASSES,
    NOISE_DRIVEN_GENERATORS,
    RNG_GENERATORS,
    build_model,
)
from articulatory_tpu_torch.models.rnn import BiGRU
from articulatory_tpu_torch.ops.interp import interpolate_linear_scale
from articulatory_tpu_torch.ops.pqmf import PQMF
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
    pqmf: PQMF | None = None  # multi-band synthesis
    # PWG / StyleMelGAN noise, seeded 0 at first use
    noise: torch.Generator | None = dataclasses.field(default=None,
                                                      repr=False)

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
        """Fold weight norm and store the conv, dense, embedding, GRU and
        attention weights as int8 (symmetric per output channel, JAX's rule,
        ``utils/quantize.py``); the frozen weights are dequantized once and
        cached."""
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
        compute dtypes stay as they are (f32 layers upcast the weights, once:
        the frozen weights are cached)."""
        if self.quantized:
            raise ValueError(
                "to_bf16_weights on an int8-quantized model would cast the "
                "dequantization scales to bf16 (silent extra rounding); "
                "pick one weight-compression scheme")
        from articulatory_tpu_torch.utils.quantize import (
            cast_bf16_,
            fold_weight_norm_,
        )

        self.remove_weight_norm()
        fold_weight_norm_(self.model)
        cast_bf16_(self.model)
        self.graphs.clear()

    def _input(self, c) -> torch.Tensor:
        """Features as a float32 (float64 kept) tensor on the device; ids
        (integers) as they are."""
        c = torch.as_tensor(c, device=self.device)
        if c.is_floating_point() and c.dtype != torch.float64:
            c = c.float()
        return c

    @torch.inference_mode()
    def __call__(self, c, ar=None) -> torch.Tensor:
        """(B, T, C) features (or a per-modality list of them, None where a
        modality is absent) [and (B, P, C_out) AR carry] -> (B, T_out,
        C_out) on the model's device."""
        if isinstance(c, (list, tuple)):
            if isinstance(self.model, MODEL_CLASSES):
                raise ValueError(
                    f"{type(self.model).__name__} takes one feature tensor, "
                    f"not a per-modality list: the multimodal decode needs "
                    f"an in_list model, and the registry has none")
            c = [None if x is None else self._input(x) for x in c]
            dtype = next(x.dtype for x in c if x is not None)
        else:
            c = self._input(c)
            dtype = c.dtype
        name = type(self.model).__name__
        if name in NOISE_DRIVEN_GENERATORS or name in RNG_GENERATORS:
            if self.noise is None:
                self.noise = torch.Generator(self.device).manual_seed(0)
            return self.model.inference(c, self.noise)
        if ar is None:
            return waveform(self.model(c))
        return waveform(self.model(c, torch.as_tensor(
            ar, device=self.device, dtype=dtype)))

    def chunk_graph(self, batch: int, feat_dim: int, ck: Chunking,
                    masked: bool = False) -> ChunkGraph:
        """The captured chunk step for this signature (``masked``: a lane
        mask keeps the carries of the lanes outside it), captured on first
        use and cached (dropped when the weights change)."""
        gen = self.model
        key = (batch, feat_dim, ck, masked,
               str(getattr(gen, "compute_dtype", None)),
               bool(getattr(gen, "hybrid_precision", False)))
        if key not in self.graphs:
            self.graphs[key] = ChunkGraph(gen, self.device, batch, feat_dim,
                                          ck, masked)
        return self.graphs[key]

    @torch.inference_mode()
    def inference(self, c: np.ndarray, normalize_before: bool = False,
                  bucket_frames: int | None = None) -> np.ndarray:
        """(T, in_feats) -> (T_out, out_channels), full utterance (a2w T *
        prod(scales) samples, multi-band ones synthesised; an inversion
        model's frames).

        ``bucket_frames`` pads T up to a multiple before the forward and trims
        the output back, as the JAX package does to bound its compile count;
        only the last receptive-field window can differ from an exact-length
        forward."""
        c = np.asarray(c)
        # integers are phoneme ids into an embedding (ph2a, ph2m)
        if not np.issubdtype(c.dtype, np.integer):
            c = c.astype(np.float32)
            if c.ndim == 1:  # a raw wave into an inversion model
                c = c[:, None]
        if normalize_before:
            c = self.normalize(c)
        t = c.shape[0]
        if bucket_frames:
            pad = (-t) % bucket_frames
            if pad:
                c = np.pad(c, [(0, pad)] + [(0, 0)] * (c.ndim - 1))
        out = self(c[None])
        if self.pqmf is not None:
            out = self.pqmf.synthesis(out)
        out = out[0].cpu().numpy()
        if bucket_frames:
            out = out[: out.shape[0] * t // c.shape[0]]
        return out


def waveform(out):
    """A generator's output without a phoneme head's logits."""
    return out[0] if isinstance(out, tuple) else out


def _load_stats(stats: str) -> tuple[np.ndarray, np.ndarray]:
    if stats.endswith(".h5"):
        return (read_hdf5(stats, "mean").reshape(-1),
                read_hdf5(stats, "scale").reshape(-1))
    arr = np.load(stats)
    return arr[0].reshape(-1), arr[1].reshape(-1)


def load_model(checkpoint: str, config: dict | str | None = None,
               stats: str | None = None, generator2: bool = False,
               device: str | torch.device | None = None) -> LoadedModel:
    """Rebuild a generator (or a ``BiGRU`` inversion model) from its config
    and a checkpoint (a JAX-package msgpack file or a reference torch
    pickle) on ``device`` (default cuda; raises without a card); with
    ``generator2`` a cascade's second stage (``generator2_type``,
    ``generator2_params``, ``model.generator2``).
    ``weight_quant: int8`` stores the weights as int8."""
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
    model = build_model(gen_type, gen_params)
    state = generator_state_dict(load_checkpoint(checkpoint), prefix,
                                 gen_params, gen_type)
    if isinstance(model, BiGRU):
        width = state["gru1.weight_ih_l0"].shape[1]
        if width != model.in_channels:
            raise ValueError(
                f"the checkpoint's BiGRU reads {width} inputs a frame (gru1 "
                f"weight_ih) but the config's in_channels is "
                f"{model.in_channels}; in_channels counts the input features "
                f"with the AR and speaker features concatenated")
    model.load_state_dict(state)
    model.to(dev).eval()
    for m in model.modules():
        if isinstance(m, nn.RNNBase):
            m.flatten_parameters()  # one weight buffer: no copy a call

    if stats is None:  # stats beside the checkpoint (reference utils.py:345)
        ext = "h5" if config.get("format", "hdf5") == "hdf5" else "npy"
        candidate = os.path.join(os.path.dirname(checkpoint), f"stats.{ext}")
        if os.path.exists(candidate):
            stats = candidate
    mean = scale = None
    if stats is not None:
        mean, scale = _load_stats(stats)
    # multiband synthesis only where the config asks for it: a w2a model's
    # channels are EMA features
    pqmf = None
    if gen_params.get("out_channels", 1) > 1 and config.get("pqmf", False):
        pqmf = PQMF(subbands=gen_params["out_channels"],
                    **config.get("pqmf_params", {})).to(dev)
    loaded = LoadedModel(model=model, config=config, device=dev, mean=mean,
                         scale=scale, pqmf=pqmf)
    if quant:
        loaded.quantize_int8()
    return loaded


@dataclasses.dataclass(frozen=True)
class Chunking:
    """How a config chunks the AR decode (JAX ``inference.py:341-350``)."""

    in_chunk_len: int  # input rows a chunk: frames (a2w), rows (w2a)
    past_out_len: int  # the carry: output samples (a2w), frames (w2a)
    out_channels: int
    # the carry is the output's tail, else a shift register; the reference
    # compares with the SAMPLE chunk length in both directions (decode.py:77)
    last_window: bool
    w2a: bool
    hop: int

    def kept_rows(self, t: int) -> int:
        """Input rows decoded: w2a drops a trailing remainder shorter than a
        hop (reference decode.py:57-58)."""
        rem = t % self.in_chunk_len
        return t - rem if self.w2a and 0 < rem < self.hop else t

    def empty(self) -> np.ndarray:
        """The output of an input with no rows to decode."""
        if self.w2a or self.out_channels > 1:
            return np.zeros((0, self.out_channels), np.float32)
        return np.zeros((0,), np.float32)


def chunking(config: dict, generator2: bool = False) -> Chunking:
    gp = config["generator2_params" if generator2 else "generator_params"]
    out_channels = gp.get("out_channels", 1)
    w2a = not generator2 and config.get("dataset_mode") == "w2a"
    chunk_len, hop = config["batch_max_steps"], config["hop_size"]
    if w2a:  # the carry holds ar_input values as frames of out_channels
        in_chunk_len = chunk_len
        past_out_len = int(gp.get("ar_input", 512) / out_channels)
    else:
        in_chunk_len = int(chunk_len / hop)
        past_out_len = gp.get("ar_input", 512)
    return Chunking(in_chunk_len, past_out_len, out_channels,
                    past_out_len <= chunk_len, w2a, hop)


def chunk_step(forward, cin: torch.Tensor, prev: torch.Tensor, ck: Chunking,
               mask: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the AR loop: ``forward(cin, prev)`` and the next carry,
    the output's tail or the shift register slid by one chunk (the output
    length in a2w, the input rows in w2a; reference decode.py:77-81). Lanes
    outside ``mask`` keep their carry. The plain version of the captured
    step."""
    out = forward(cin, prev)
    if ck.last_window:
        new_prev = out[:, -ck.past_out_len:, :]
    else:
        shift = cin.shape[1] if ck.w2a else out.shape[1]
        new_prev = torch.cat([prev[:, shift:, :], out], dim=1)
    if mask is not None:
        new_prev = torch.where(mask[:, None, None], new_prev, prev)
    return out, new_prev


class ChunkGraph:
    """One chunk step of the AR loop captured in a CUDA graph: the forward
    on a static input ``(B, in_chunk_len, F)`` and carry ``(B, P, C_out)``,
    then the carry update (with ``masked``, through a static lane mask)
    written back into the static carry. ``WARMUP_STEPS`` eager steps on the
    capture stream come first, so that every first-use host step of the
    kernels (shared-memory attributes, launch plans, tensor maps, the f32
    weight splits cached on the frozen kernels) happens outside the capture.
    The graph keeps the frozen kernels it reads alive."""

    @torch.inference_mode()
    def __init__(self, model: nn.Module, device: torch.device, batch: int,
                 feat_dim: int, ck: Chunking, masked: bool = False):
        self.static_in = torch.zeros((batch, ck.in_chunk_len, feat_dim),
                                     device=device)
        self.static_prev = torch.zeros((batch, ck.past_out_len,
                                        ck.out_channels), device=device)
        self.static_mask = (torch.ones((batch,), dtype=torch.bool,
                                       device=device) if masked else None)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        def forward(c, prev):
            return waveform(model(c, prev))

        with torch.cuda.stream(stream):
            for _ in range(WARMUP_STEPS):
                chunk_step(forward, self.static_in, self.static_prev, ck,
                           self.static_mask)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                # a fresh carry first: the shift register reads the old one
                self.static_out, new_prev = chunk_step(
                    forward, self.static_in, self.static_prev, ck,
                    self.static_mask)
                self.static_prev.copy_(new_prev)
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the chunk step (B {batch}, {ck.in_chunk_len} "
                f"rows x {feat_dim}, carry {ck.past_out_len}) in a CUDA graph "
                f"failed; on a card the scan decode runs only as a graph"
            ) from e
        self.weights = [t for m in model.modules()
                        for t in (getattr(m, "_frozen", None) or {}).values()
                        if t is not None]

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

    @torch.inference_mode()
    def step(self, cin: torch.Tensor, prev: torch.Tensor,
             mask: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """One replay from carry ``prev`` (and ``mask``): the output and the
        next carry, as copies that later replays leave alone."""
        self.static_in.copy_(cin)
        self.static_prev.copy_(prev)
        if mask is not None:
            self.static_mask.copy_(mask)
        self.graph.replay()
        return self.static_out.clone(), self.static_prev.clone()


def _eager_chunks(model: LoadedModel, chunks: torch.Tensor,
                  ck: Chunking) -> torch.Tensor:
    """The chunk loop eagerly: chunks ``(n, B, T, F)`` -> ``(B, n * T_out,
    C_out)``."""
    prev = torch.zeros((chunks.shape[1], ck.past_out_len, ck.out_channels),
                       device=model.device)
    outs = []
    for cin in chunks:
        cout, prev = chunk_step(model, cin, prev, ck)
        outs.append(cout)
    return torch.cat(outs, dim=1)


def _scan_chunks(model: LoadedModel, chunks: np.ndarray,
                 ck: Chunking) -> np.ndarray:
    """chunks ``(n, B, T, F)`` -> ``(B, n * T_out, C_out)``: one upload, the
    captured chunk step replayed once a chunk on a card (the eager loop on
    the CPU), one host sync."""
    dev_chunks = torch.from_numpy(np.ascontiguousarray(chunks)).to(
        model.device)
    if model.device.type == "cpu":
        return _eager_chunks(model, dev_chunks, ck).numpy()
    n, b, _, feat_dim = chunks.shape
    outs = model.chunk_graph(b, feat_dim, ck).run(dev_chunks)  # (n, B, T, C)
    return outs.transpose(0, 1).reshape(b, -1, outs.shape[-1]).cpu().numpy()


def ar_loop(model: LoadedModel, x: np.ndarray, config: dict,
            do_wsola: bool = False, modality: int | None = None,
            generator2: bool = False):
    """Chunked AR decode of one utterance (reference decode.py:31-100).
    a2w: features (T, num_feats) -> waveform (T * hop,) (or (T * hop,
    C_out)); w2a: input rows (T, F) (a raw wave may be 1-D) -> trajectories
    (T', C_out). float64 input decodes in float64 (the model must be float64
    too). ``do_wsola`` (a2w): 50 %-overlap windows instead, -> (list of each
    window's waveform, list of its input frames). ``modality`` (a2w): x
    holds that modality's frames; each chunk, interpolated onto the common
    frame rate, goes to the model in a per-modality list."""
    ck = chunking(config, generator2)
    x = np.asarray(x)
    # float64 kept for parity decodes; everything else computes in float32
    x = x if x.dtype == np.float64 else x.astype(np.float32)
    forward = (model if modality is None
               else _in_list(model, config, modality, generator2))
    if x.ndim == 1:
        x = x[:, None]
    if do_wsola:
        if ck.w2a:
            raise NotImplementedError("WSOLA decodes waveforms; w2a has none")
        params_key = "generator2_params" if generator2 else "generator_params"
        return _wsola(model, x, config, params_key, ck)
    t = ck.kept_rows(len(x))
    xt = torch.from_numpy(np.ascontiguousarray(x[:t])).to(model.device)
    prev = torch.zeros((1, ck.past_out_len, ck.out_channels), dtype=xt.dtype,
                       device=model.device)
    outs = []
    for i in range(0, t, ck.in_chunk_len):
        cout, prev = chunk_step(forward, xt[None, i:i + ck.in_chunk_len],
                                prev, ck)
        outs.append(cout[0])
    if not outs:
        return ck.empty()
    out = torch.cat(outs, dim=0).cpu().numpy()
    return out[:, 0] if not ck.w2a and out.shape[1] == 1 else out


def _in_list(model, config: dict, modality: int, generator2: bool):
    """``forward(cin, prev)`` of the multimodal decode (reference
    decode.py:52-53, 67-71): the chunk of ``modality``'s frames,
    interpolated onto the common frame rate, as that entry of the in-list
    model's per-modality input."""
    gp = config["generator2_params" if generator2 else "generator_params"]
    scale = (config["sampling_rate"] / config["hop_size"]
             * config["hop_sizes"][modality]
             / config["sampling_rates"][modality])
    n_modalities = len(gp["in_list"])

    def forward(cin: torch.Tensor, prev: torch.Tensor):
        cin_list = [None] * n_modalities
        cin_list[modality] = interpolate_linear_scale(cin, scale)
        return model(cin_list, prev)

    return forward


def _wsola(model: LoadedModel, x: np.ndarray, config: dict, params_key: str,
           ck: Chunking):
    """WSOLA decode (JAX ``ar_loop(do_wsola=True)``): windows of
    ``in_chunk_len`` frames (+1 with ``extra_art``) every half chunk; each
    window's carry is the previous output's samples just before its middle."""
    in_chunk_len, past_out_len = ck.in_chunk_len, ck.past_out_len
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
    """Throughput-mode chunked AR decode over a batch of utterances, in
    either direction.

    Each utterance keeps its own AR carry; inputs are zero-padded to a common
    chunk count and outputs trimmed to each utterance's length (w2a: after
    the sub-hop tail drop, by the model's output frames a chunk). Outputs
    match the sequential ``ar_loop`` on every complete chunk. ``scan=True``
    runs the same lane semantics through the captured chunk step (one
    upload, one replay a chunk, one host sync; the eager loop on the CPU)."""
    ck = chunking(config)
    b = len(xs)
    lengths = [ck.kept_rows(len(x)) for x in xs]
    n_chunks = max(-(-t // ck.in_chunk_len) for t in lengths)
    if n_chunks == 0:
        return [ck.empty() for _ in xs]
    feat_dim = xs[0].shape[1] if xs[0].ndim == 2 else 1
    batch = np.zeros((b, n_chunks * ck.in_chunk_len, feat_dim), np.float32)
    for i, x in enumerate(xs):
        batch[i, : lengths[i]] = np.asarray(x, np.float32).reshape(
            len(x), feat_dim)[: lengths[i]]
    chunks = batch.reshape(b, n_chunks, ck.in_chunk_len,
                           feat_dim).swapaxes(0, 1)
    if scan:
        out = _scan_chunks(model, chunks, ck)
    else:
        out = _eager_chunks(model, torch.from_numpy(
            np.ascontiguousarray(chunks)).to(model.device), ck).cpu().numpy()
    if ck.w2a:  # output frames a chunk are the model's (T -> T for a BiGRU)
        fpc = out.shape[1] // n_chunks
        return [out[i, : lengths[i] * fpc // ck.in_chunk_len]
                for i in range(b)]
    return [out[i, : lengths[i] * ck.hop, 0] if ck.out_channels == 1
            else out[i, : lengths[i] * ck.hop] for i in range(b)]


def ar_loop_scan(model: LoadedModel, x: np.ndarray, config: dict,
                 chunk_bucket: int = 0) -> np.ndarray:
    """One utterance through the captured chunk step (JAX
    ``ar_loop_scan``), in either direction. ``chunk_bucket`` rounds the
    chunk count up to a multiple (the padded chunks are computed and
    dropped); 0 = exact.

    a2w: pad to whole chunks, run them all, trim to ``T * hop``. A ragged
    last chunk is computed under zero padding, as in the JAX package; near
    its end it differs from ``ar_loop``'s short chunk, whose padding carries
    no tiled AR features. w2a: the whole chunks run captured, then a ragged
    tail (at least a hop) runs as one exact-shape forward seeded with the
    last ``past_out_len`` output frames, zero-prefixed: the carry that both
    regimes hold there. A sub-hop tail is dropped."""
    ck = chunking(config)
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    if ck.w2a:
        return _w2a_scan(model, x, ck, chunk_bucket)
    t = len(x)
    n_chunks = max(-(-t // ck.in_chunk_len), 1)
    if chunk_bucket:
        n_chunks = -(-n_chunks // chunk_bucket) * chunk_bucket
    xp = np.pad(x, ((0, n_chunks * ck.in_chunk_len - t), (0, 0)))
    chunks = xp.reshape(n_chunks, 1, ck.in_chunk_len, x.shape[1])
    out = _scan_chunks(model, chunks, ck)[0]
    return (out[: t * ck.hop, 0] if out.shape[1] == 1
            else out[: t * ck.hop])


def _w2a_scan(model: LoadedModel, x: np.ndarray, ck: Chunking,
              chunk_bucket: int) -> np.ndarray:
    """``ar_loop_scan`` in w2a (JAX ``inference.py:626-659``)."""
    t = ck.kept_rows(len(x))
    full, rem = divmod(t, ck.in_chunk_len)
    out = ck.empty()
    if full:
        n_chunks = (-(-full // chunk_bucket) * chunk_bucket if chunk_bucket
                    else full)
        xp = np.zeros((n_chunks * ck.in_chunk_len, x.shape[1]), np.float32)
        xp[: full * ck.in_chunk_len] = x[: full * ck.in_chunk_len]
        scanned = _scan_chunks(model, xp.reshape(
            n_chunks, 1, ck.in_chunk_len, x.shape[1]), ck)[0]
        out = scanned[: full * (scanned.shape[0] // n_chunks)]
    if rem:
        carry = np.concatenate([np.zeros((ck.past_out_len, ck.out_channels),
                                         np.float32), out])
        tail = model(x[None, full * ck.in_chunk_len:t],
                     ar=carry[None, len(carry) - ck.past_out_len:])
        out = np.concatenate([out, tail[0].cpu().numpy()])
    return out
