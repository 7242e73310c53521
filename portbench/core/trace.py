"""The measured window, and with ``--trace 1`` its ``torch.profiler`` traces
reduced to what the metric readers take.

A traced run splits its window into three phases of equal length
(``PHASES``): ``host``, with no profiler, for rates and times by the host
clock; ``device``, profiled with CUDA activity alone (no host op is
recorded, though the host's launches still run slower), for the device's
busy time; ``ops``, profiled with host ops too, for the device time of
named kernels and of the kernels each host op launched, and the breakdown.

The harness marks its own calls into the program with spans
(``record_function`` ranges named ``portbench.<what>``) in the ``ops``
phase. The device's busy time is the union of its kernels' and copies'
intervals inside the window (device-side copies of the ranges left out);
an idle gap is named by the harness span and the host op (or ``python``,
between ops) running at its middle.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import math
import time

import torch

WINDOW = "portbench.window"
PHASES = ("host", "device", "ops")
# idle host time that opens a profiler window: the profiler drops device
# records that it dates before its start, and now and then dates them a few
# ms early
LEAD_S = 0.05
TOP = 10


def span(traced: bool, name: str):
    """A harness span around a call into the program (traced runs only)."""
    return (torch.profiler.record_function(f"portbench.{name}") if traced
            else contextlib.nullcontext())


@dataclasses.dataclass
class Trace:
    """A traced window, times in us. ``device``: (name, start, end, the
    correlation id of the host op that launched it) inside the window;
    ``ops``: correlation id -> name of every host op; ``top``: (start, end,
    name) of the host ops that no other op of their thread encloses;
    ``spans``: (name, start, end) of the harness's spans."""
    start_us: float
    end_us: float
    device: list
    ops: dict
    top: list
    spans: list

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        merged = []
        for s, e in sorted((s, e) for _, s, e, _ in self.device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_s(self, names) -> tuple[float, int]:
        """Seconds of device work whose name holds one of ``names``, and
        the count of those events."""
        hits = [(e - s) for n, s, e, _ in self.device
                if any(k in n for k in names)]
        return sum(hits) / 1e6, len(hits)

    def count(self, name: str) -> int:
        return sum(name in n for n, _, _, _ in self.device)

    def launched_by_s(self, text: str) -> float:
        """Seconds of device work launched by host ops whose name holds
        ``text``."""
        return sum(e - s for _, s, e, c in self.device
                   if text in self.ops.get(c, "")) / 1e6

    def breakdown(self) -> dict:
        ops = collections.Counter()
        for n, s, e, _ in self.device:
            ops[n[:120]] += (e - s) / 1e6
        gaps = collections.Counter()
        edges = [self.start_us] + [t for iv in self.busy_intervals()
                                   for t in iv] + [self.end_us]
        starts = [t[0] for t in self.top]
        spans = sorted((s, e, n) for n, s, e in self.spans if n != WINDOW)
        span_starts = [s[0] for s in spans]
        for lo, hi in zip(edges[::2], edges[1::2]):
            if hi <= lo:
                continue
            mid = (lo + hi) / 2
            name = _op_at(spans, span_starts, mid, "harness", 1)
            op = _op_at(self.top, starts, mid, "python", 64)
            gaps[f"{name.removeprefix('portbench.')}/{op}"] += (hi - lo) / 1e6
        return {"device_ops": [[n, s] for n, s in ops.most_common(TOP)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(TOP)]}


def _op_at(ops, starts, t, default: str, look_back: int) -> str:
    """The name of one of ``ops`` ((start, end, name), sorted, ``starts``
    their starts) running at ``t``, among the ``look_back`` that started
    last before it, else ``default``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - look_back, -1), -1):
        if ops[j][1] >= t:
            return ops[j][2]
    return default


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """``with Window(phase, device) as w:`` a measured window (or one phase
    of a traced run's, ``PHASES``; ``None`` for an untraced run);
    ``w.seconds`` after it, and ``w.trace`` in a profiled phase. The device
    is synchronised before the window opens and before it closes."""

    def __init__(self, phase: str | None, device: torch.device):
        self.phase, self.device = phase, device
        self.trace: Trace | None = None
        self._prof = None

    def __enter__(self):
        # a device phase without a card has no activity to trace
        if self.phase == "ops" or (self.phase == "device"
                                   and self.device.type == "cuda"):
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CUDA]
            if self.phase == "ops":
                activities.append(ProfilerActivity.CPU)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
            time.sleep(LEAD_S)
            if self.phase == "ops":
                self._range = torch.profiler.record_function(WINDOW)
                self._range.__enter__()
        synchronize(self.device)
        self.start = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def __exit__(self, *exc):
        synchronize(self.device)
        self.seconds = time.perf_counter() - self.start
        if self._prof is not None:
            if self.phase == "ops":
                self._range.__exit__(*exc)
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.trace = reduce(self._prof, None if self.phase == "ops"
                                    else self.seconds)
        elif self.phase == "device":
            self.trace = Trace(0.0, self.seconds * 1e6, [], {}, [], [])
        return False


def reduce(prof, seconds: float | None = None) -> Trace:
    """The profiler's raw events (its per-op event tree, which takes
    minutes to build for a window of eager training steps, is not built).
    A trace of device activity alone has no window range: every device
    event falls inside the window, which the device was idle before and
    after, and ``seconds`` is its length by the host clock."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    if seconds is not None:
        device = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
                   e.linked_correlation_id()) for e in events
                  if e.device_type() == cuda and not e.is_user_annotation()]
        lo = min((s for _, s, _, _ in device), default=0.0)
        return Trace(lo, lo + seconds * 1e6, device, {}, [], [])
    window = [e for e in events if e.name() == WINDOW
              and e.device_type() == cpu]
    if not window:
        raise RuntimeError("the profiler recorded no window range")
    lo, hi = window[0].start_ns() / 1e3, window[0].end_ns() / 1e3
    device, ops, spans, host = [], {}, [], collections.defaultdict(list)
    for e in events:
        start, end = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == cuda:
            s, t = max(start, lo), min(end, hi)
            if t > s and not e.is_user_annotation():
                device.append((e.name(), s, t, e.linked_correlation_id()))
        elif e.is_user_annotation():
            if e.name().startswith("portbench."):
                spans.append((e.name(), start, end))
        else:
            ops[e.correlation_id()] = e.name()
            host[e.start_thread_id()].append((start, end, e.name()))
    top = []
    for thread_ops in host.values():
        edge = -math.inf
        for start, end, name in sorted(thread_ops):
            if start >= edge:
                top.append((start, end, name))
                edge = end
    return Trace(lo, hi, device, ops, sorted(top), spans)
