"""What the metric files share: shares of the device's time and of the
peaks, from a run's counts and its trace (``runner.Run``). A reader with
nothing to read returns None, and the metric is left out of the line."""

from __future__ import annotations

import math

import numpy as np

from portbench import flops
from portbench.core import peaks


def device_idle_pct(run) -> float | None:
    """100 - the busy share of the phase traced for device activity
    alone."""
    phase = run.phase("device")
    if phase is None or not phase.trace.device:
        return None
    return 100.0 * (1.0 - phase.trace.busy_s / phase.trace.window_s)


def paced_idle_pct(run, unit: str) -> float | None:
    """100 - the device's busy share at the untraced pace: its busy time a
    ``unit`` in the phase traced for device activity alone, over the time
    a ``unit`` takes in the untraced phase. Tracing slows the host's
    launches, not the device's work."""
    device, host = run.phase("device"), run.phase("host")
    if device is None or not device.trace.device or not (
            device.counts[unit] and host.counts[unit]):
        return None
    busy = device.trace.busy_s / device.counts[unit]
    return 100.0 * (1.0 - busy * host.counts[unit] / host.seconds)


def decode_mfu_pct(run) -> float | None:
    """Model FLOPs of each utterance's own chunks (not the padding) over
    the untraced phase, against the dense peak of the cell's precision."""
    phase = run.phase("host")
    if phase is None:
        return None
    model = run.cell.model
    chunk = model["batch_max_steps"] // model["hop_size"]
    per_chunk = flops.generator_flops(model["generator_params"], chunk)
    chunks = sum(math.ceil(f / chunk) for f in phase.counts["frames"])
    return (100.0 * chunks * per_chunk / phase.seconds
            / peaks.MODEL_PEAK[run.cell.precision])


def train_mfu_pct(run) -> float | None:
    """The steps' model FLOPs over the untraced phase."""
    phase = run.phase("host")
    if phase is None:
        return None
    model = run.cell.model
    step = flops.train_step_flops(model, run.cell.traffic["batch"])
    return (100.0 * phase.counts["steps"] * step / phase.seconds
            / peaks.MODEL_PEAK[run.cell.precision])


def roofline_pct(run, kernel, calls: list[tuple]) -> float | None:
    """The least time of the kernel's calls in the ``ops`` phase over the
    device time of its kernels (``kernel.NAMES``). ``calls`` are the
    arguments of ``kernel.bound_s`` for one repeat of the work (a forward,
    a step); the phase holds as many repeats as ``kernel.CALL`` kernels
    over ``len(calls)``."""
    phase = run.phase("ops")
    if phase is None or not calls:
        return None
    seconds, _ = phase.trace.kernel_s(kernel.NAMES)
    launched = phase.trace.count(kernel.CALL)
    if launched == 0 or seconds <= 0:
        return None
    bound = sum(kernel.bound_s(*c) for c in calls) / len(calls)
    return 100.0 * launched * bound / seconds


def decode_pair_calls(run) -> list[tuple]:
    model = run.cell.model
    chunk = model["batch_max_steps"] // model["hop_size"]
    return flops.pair_calls(model["generator_params"], run.cell.precision,
                            run.counts["lanes"], chunk)


def latency_ms(run, q: float, phase: str | None = None) -> float | None:
    """The ``q``-th percentile latency of the window, or of one ``phase``
    of a traced run's."""
    counts = run.counts if phase is None else getattr(run.phase(phase),
                                                      "counts", {})
    lat = counts.get("latencies_s")
    if not lat:
        return None
    return 1e3 * float(np.percentile(lat, q))
