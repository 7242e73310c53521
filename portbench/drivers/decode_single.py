"""Single-stream synthesis: one utterance at a time through
``inference.py::ar_loop_scan(model, x, config)``, back to back (closed
loop). An utterance's latency runs from the call to its waveform on the
host.

Traffic keys: ``seconds`` [lo, hi], each block of ``block`` utterances one
a stratum; ``pool``, the feature rows (utterance j reads row j % pool);
``check_utterances``, the utterances the output check follows (the
longest first, the rest drawn from the seed).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.core import program, traffic
from portbench.core.trace import span
from portbench.reference import decode


class Driver:
    def __init__(self, cell, seed: int, dev: torch.device):
        from articulatory_tpu_torch.inference import ar_loop_scan
        self.entry = ar_loop_scan
        self.cell, self.seed, self.dev = cell, seed, dev
        self.model, t = cell.model, cell.traffic
        self.loaded, self.weights = program.decoder(self.model, seed, dev)
        feat = traffic.features(self.model)
        self.pool = traffic.feature_pool(
            seed, t["pool"], traffic.max_frames(t, self.model), feat, dev)
        self.done = []  # (frames, waveform, latency s) of each utterance

    def _input(self, j: int) -> np.ndarray:
        block = self.cell.traffic["block"]
        frames = traffic.stratified_frames(self.seed, j // block, block,
                                           self.cell.traffic, self.model)
        return self.pool[j % len(self.pool), :frames[j % block]]

    def warm(self) -> None:
        """The captured chunk step, and the longest and shortest input."""
        t = self.cell.traffic
        for frames in (traffic.max_frames(t, self.model), 1):
            self.entry(self.loaded, self.pool[0, :frames], self.model)

    def unit(self, j: int, traced: bool) -> None:
        with span(traced, "draw"):
            x = self._input(j)
        start = time.perf_counter()
        with span(traced, "ar_loop_scan"):
            out = self.entry(self.loaded, x, self.model)
        self.done.append((len(x), out, time.perf_counter() - start))

    def counts(self, first: int, last: int) -> dict:
        """Over units ``first`` to ``last`` (excluded) of the window."""
        hop, done = self.model["hop_size"], self.done[first:last]
        failed = sum(out.shape != (f * hop,) or not np.isfinite(out).all()
                     for f, out, _ in done)
        return {"attempted": len(done), "failed": int(failed),
                "samples": sum(f for f, _, _ in done) * hop,
                "frames": [f for f, _, _ in done], "lanes": 1,
                "latencies_s": [s for _, _, s in done]}

    def free(self) -> None:
        del self.loaded
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check_units(self) -> int:
        return self.cell.traffic["check_utterances"]

    def serve_reference(self, precision: str) -> None:
        """Put the reference's own decode in ``precision`` in place of what
        the program served (the check's control)."""
        outs = decode.free_run(self.weights, self.model,
                               [self._input(j) for j in range(len(self.done))],
                               precision, self.dev)
        self.done = [(frames, out, latency) for (frames, _, latency), out
                     in zip(self.done, outs)]

    def check(self) -> list[dict]:
        picked = traffic.checked([f for f, _, _ in self.done],
                                 self.cell.traffic["check_utterances"],
                                 self.seed)
        lanes = [(self._input(j), self.done[j][1]) for j in picked]
        got = decode.teacher_forced_gap(self.weights, self.model, lanes,
                                        self.cell.precision, self.dev)
        return [{"name": "decode_gap", "value": got["gap"],
                 "limit": self.cell.spec["limits"]["decode_gap"]}]
