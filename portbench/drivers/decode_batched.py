"""Offline batch synthesis: ``inference.py::ar_loop_batched(model, xs,
config, scan=True)``, as ``bin/decode.py --decode-batch-size B --ar-scan``
runs it, one batch of ``batch`` utterances after another (closed loop).

Traffic keys: ``batch``; ``seconds`` [lo, hi], each batch one utterance a
stratum; ``pool``, the feature rows per lane (batch j reads row j % pool);
``check_batches``, the batches the output check follows (the one holding
the longest utterance first, the rest drawn from the seed).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.core import program, traffic
from portbench.core.trace import span
from portbench.reference import decode


class Driver:
    def __init__(self, cell, seed: int, dev: torch.device):
        from articulatory_tpu_torch.inference import ar_loop_batched
        self.entry = ar_loop_batched
        self.cell, self.seed, self.dev = cell, seed, dev
        self.model, t = cell.model, cell.traffic
        self.batch = t["batch"]
        self.loaded, self.weights = program.decoder(self.model, seed, dev)
        feat = traffic.features(self.model)
        self.pool = traffic.feature_pool(
            seed, t["pool"] * self.batch, traffic.max_frames(t, self.model),
            feat, dev).reshape(t["pool"], self.batch, -1, feat)
        self.done = []  # (frames, outputs) of each batch of the window

    def _inputs(self, j: int):
        frames = traffic.stratified_frames(self.seed, j, self.batch,
                                           self.cell.traffic, self.model)
        rows = self.pool[j % len(self.pool)]
        return frames, [rows[i, :f] for i, f in enumerate(frames)]

    def warm(self) -> None:
        """The captured chunk step of this batch shape, and one batch."""
        self.entry(self.loaded, self._inputs(-1)[1], self.model, scan=True)

    def unit(self, j: int, traced: bool) -> None:
        with span(traced, "draw"):
            frames, xs = self._inputs(j)
        with span(traced, "ar_loop_batched"):
            outs = self.entry(self.loaded, xs, self.model, scan=True)
        self.done.append((frames, outs))

    def counts(self, first: int, last: int) -> dict:
        """Over units ``first`` to ``last`` (excluded) of the window."""
        hop, done = self.model["hop_size"], self.done[first:last]
        frames = [f for fs, _ in done for f in fs]
        failed = sum(out.shape != (f * hop,) or not np.isfinite(out).all()
                     for fs, outs in done for f, out in zip(fs, outs))
        return {"attempted": len(frames), "failed": int(failed),
                "samples": int(sum(frames)) * hop, "frames": frames,
                "lanes": self.batch}

    def free(self) -> None:
        del self.loaded
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check_units(self) -> int:
        return self.cell.traffic["check_batches"]

    def serve_reference(self, precision: str) -> None:
        """Put the reference's own decode in ``precision`` in place of what
        the program served (the check's control)."""
        for j, (frames, _) in enumerate(self.done):
            xs = self._inputs(j)[1]
            self.done[j] = (frames, decode.free_run(
                self.weights, self.model, xs, precision, self.dev))

    def check(self) -> list[dict]:
        picked = traffic.checked([fs.max() for fs, _ in self.done],
                                 self.cell.traffic["check_batches"],
                                 self.seed)
        lanes = []
        for j in picked:
            lanes += list(zip(self._inputs(j)[1], self.done[j][1]))
        got = decode.teacher_forced_gap(self.weights, self.model, lanes,
                                        self.cell.precision, self.dev)
        return [{"name": "decode_gap", "value": got["gap"],
                 "limit": self.cell.spec["limits"]["decode_gap"]}]
