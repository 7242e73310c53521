"""Streaming synthesis and inversion, and a stream server (port of
``articulatory_tpu/streaming.py``).

``StreamingSynthesizer`` owns the AR carry of ``batch`` lanes and turns
fixed-size chunks into outputs, one chunk step each, in constant memory and
time a chunk (reference semantics: decode.py:31-82). a2w: chunks of
``batch_max_steps / hop_size`` feature frames give ``batch_max_steps``
samples. w2a (``dataset_mode: w2a``): chunks of ``batch_max_steps`` input
rows give trajectory frames; the carry holds ``ar_input / out_channels``
frames, and a trailing sub-hop remainder of a stream is dropped.

``StreamingServer`` serves clients that join and leave on ``max_lanes``
fixed lanes: a round steps every lane, a lane mask keeps the carry of the
lanes that sent nothing (idle, or a joined client that stalls), and a
joining client's lane starts from a zeroed carry, so a stream's outputs do
not depend on its neighbours.

On a card one chunk step (the forward, the carry update and, for the
server, the masked carry select) is a CUDA graph (``inference.ChunkGraph``)
captured once per (lanes, chunk, features, carry, regime, direction,
compute mode, masked) and replayed every chunk; churn only rewrites the
mask. Each replay's output and carry are copied out of the graph's static
buffers, so chunks kept in flight (``synthesize(pipeline_depth)``) survive
later replays. On the CPU the same step runs eagerly (the plain version).

Two differences from the JAX package, neither of which changes a valid
stream's outputs: a joining lane's carry is zeroed by a select, not by a
multiply by 0 (a NaN a previous client left there would survive that), and
a client that sent a short (final) chunk may send no more.
"""

from __future__ import annotations

import numpy as np
import torch

from articulatory_tpu_torch.inference import (
    LoadedModel,
    ar_loop_scan,
    chunk_step,
    chunking,
)


class StreamingSynthesizer:
    def __init__(self, model: LoadedModel, config: dict, batch: int = 1):
        ck = chunking(config)
        if ck.out_channels > 1 and not ck.w2a and config.get("pqmf", False):
            raise NotImplementedError(
                "multiband (PQMF) generators are not supported in streaming "
                "mode; use LoadedModel.inference or the batched decode")
        self.model, self.config, self.ck, self.batch = model, config, ck, batch
        self.reset()

    @property
    def chunk_frames(self) -> int:
        """Input rows a chunk step takes."""
        return self.ck.in_chunk_len

    @property
    def shift_register(self) -> bool:
        """Whether the carry slides (else it is the last window's output)."""
        return not self.ck.last_window

    def reset(self, lanes: slice | None = None) -> None:
        """Zero the AR carry of every lane, or of ``lanes`` (by a select: a
        NaN left in a lane does not survive it)."""
        if lanes is None:
            self._prev = torch.zeros(
                (self.batch, self.ck.past_out_len, self.ck.out_channels),
                device=self.model.device)
            return
        keep = torch.ones((self.batch,), dtype=torch.bool)
        keep[lanes] = False
        self._prev = torch.where(keep.to(self.model.device)[:, None, None],
                                 self._prev, 0.0)

    def _step(self, feats: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
        """One chunk step of every lane from the carry, which it advances
        (lanes outside ``mask`` keep theirs); returns the output."""
        if self.model.device.type == "cpu":
            out, prev = chunk_step(self.model, feats, self._prev, self.ck,
                                   mask)
            self._prev = prev.clone()  # not a view of the returned output
            return out
        graph = self.model.chunk_graph(self.batch, feats.shape[-1], self.ck,
                                       masked=mask is not None)
        out, self._prev = graph.step(feats, self._prev, mask)
        return out

    def synthesize_chunk(self, feats: np.ndarray) -> np.ndarray:
        """feats ``(batch, chunk_frames, C)``, or ``(chunk_frames, C)`` for
        one lane -> ``(batch, chunk_frames * hop, out_channels)`` samples,
        or ``(batch, out_frames, out_channels)`` trajectories in w2a."""
        return self.dispatch_chunk(feats).cpu().numpy()

    def dispatch_chunk(self, feats: np.ndarray) -> torch.Tensor:
        """``synthesize_chunk`` without waiting: the output stays on the
        device, in a tensor of its own, until the caller reads it."""
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 1:  # a raw wave of one lane
            feats = feats[:, None]
        if feats.ndim == 2:
            feats = feats[None]
        if feats.shape[:2] != (self.batch, self.chunk_frames):
            raise ValueError(f"streaming chunks are ({self.batch}, "
                             f"{self.chunk_frames}, C); got {feats.shape}")
        return self._step(torch.from_numpy(feats).to(self.model.device))

    def synthesize(self, feats: np.ndarray, pipeline_depth: int = 2):
        """Yield the outputs of a whole ``(T, C)`` stream chunk by chunk,
        with ``pipeline_depth`` chunks dispatched ahead of the one read. The
        trailing partial chunk is zero-padded and its output trimmed; in w2a
        a sub-hop remainder is dropped and the trim follows the model's
        output frames a chunk."""
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 1:
            feats = feats[:, None]
        t = self.ck.kept_rows(len(feats))
        pad = (-t) % self.chunk_frames
        feats = np.pad(feats[:t], ((0, pad), (0, 0)))

        def trim(start: int, out: torch.Tensor) -> np.ndarray:
            out = out[0].cpu().numpy()
            kept = min(self.chunk_frames, t - start)
            if self.ck.w2a:
                return out[: kept * out.shape[0] // self.chunk_frames]
            return out[: kept * self.ck.hop]

        inflight: list[tuple[int, torch.Tensor]] = []
        for start in range(0, t + pad, self.chunk_frames):
            inflight.append((start, self.dispatch_chunk(
                feats[start:start + self.chunk_frames])))
            if len(inflight) > max(pipeline_depth, 1):
                yield trim(*inflight.pop(0))
        for item in inflight:
            yield trim(*item)

    def synthesize_all(self, feats: np.ndarray) -> np.ndarray:
        """A whole known stream through ``ar_loop_scan`` (one lane): ``(T *
        hop,)`` samples, or ``(frames, out_channels)`` trajectories in w2a;
        the concatenation of ``synthesize``'s chunks."""
        if self.batch != 1:
            raise ValueError("synthesize_all is a single-lane path")
        return ar_loop_scan(self.model, np.asarray(feats, np.float32),
                            self.config)


class StreamingServer:
    """Continuous batching of streams on ``max_lanes`` fixed lanes.

    A lane's output never depends on the other lanes' occupancy or data; a
    joined client that sends nothing in a round keeps its carry; a joining
    client starts from a zeroed carry and gets the outputs of a fresh
    stream in the same geometry, bit for bit."""

    def __init__(self, model: LoadedModel, config: dict, max_lanes: int = 16):
        self.syn = StreamingSynthesizer(model, config, batch=max_lanes)
        self.max_lanes = max_lanes
        self._lane_of: dict[object, int] = {}
        self._free = list(range(max_lanes))[::-1]  # pop() -> lowest index
        self._ended: set = set()  # clients that sent a short (final) chunk

    def join(self, client_id) -> int:
        """Admit a stream; returns its lane, whose carry is zeroed."""
        if client_id in self._lane_of:
            raise ValueError(f"client {client_id!r} already joined")
        if not self._free:
            raise RuntimeError(
                f"server full ({self.max_lanes} lanes); leave() a stream "
                f"first or build a wider server")
        lane = self._free.pop()
        self._lane_of[client_id] = lane
        self.syn.reset(slice(lane, lane + 1))
        return lane

    def leave(self, client_id) -> None:
        """Retire a stream; its lane is free at once."""
        self._free.append(self._lane_of.pop(client_id))
        self._ended.discard(client_id)

    @property
    def active(self) -> list:
        return list(self._lane_of)

    def step(self, chunks: dict) -> dict:
        """One round: ``{client_id: (t, C) chunk}`` -> ``{client_id:
        output}``. A chunk has 1 to ``chunk_frames`` rows (a 1-D chunk is
        ``(t, 1)``); a shorter one is the stream's last, zero-padded through
        the step and its output trimmed (a2w ``t * hop`` samples, w2a by the
        model's output frames a chunk). Joined clients absent from
        ``chunks`` keep their carry."""
        if not chunks:
            return {}
        syn = self.syn
        unknown = [c for c in chunks if c not in self._lane_of]
        if unknown:
            raise KeyError(f"clients not joined: {unknown!r}")
        ended = [c for c in chunks if c in self._ended]
        if ended:
            raise ValueError(f"clients {ended!r} already sent a short (final) "
                             f"chunk; leave and join again for a new stream")
        norm = {}
        for cid, chunk in chunks.items():
            chunk = np.asarray(chunk, np.float32)
            if chunk.ndim == 1:
                chunk = chunk[:, None]
            if not 0 < len(chunk) <= syn.chunk_frames:
                raise ValueError(
                    f"chunk for {cid!r} must be 1..{syn.chunk_frames} "
                    f"frames, got {len(chunk)}")
            norm[cid] = chunk
        feat_dim = next(iter(norm.values())).shape[-1]
        batch = np.zeros((self.max_lanes, syn.chunk_frames, feat_dim),
                         np.float32)
        mask = np.zeros((self.max_lanes,), bool)
        for cid, chunk in norm.items():
            lane = self._lane_of[cid]
            batch[lane, : len(chunk)] = chunk
            mask[lane] = True
        device = syn.model.device
        got = syn._step(torch.from_numpy(batch).to(device),
                        torch.from_numpy(mask).to(device)).cpu().numpy()
        results = {}
        for cid, chunk in norm.items():
            t = len(chunk)
            keep = (t * got.shape[1] // syn.chunk_frames if syn.ck.w2a
                    else t * syn.ck.hop)
            results[cid] = got[self._lane_of[cid], :keep]
            if t < syn.chunk_frames:
                self._ended.add(cid)
        return results
