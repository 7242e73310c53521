"""The share of the backward phases' device ms a step in which the device
sat idle, at the untraced pace: ``100 * (B_u - busy) / B_u``.

``B_u`` is the device ms a step of ``generator_backward`` and
``discriminator_backward`` in the untraced phase, from the port's own step
account (``articulatory_tpu_torch/trace.py``). ``busy`` is the same in the
phase traced for device activity alone, less that phase's idle gaps (between
the union of its kernels' and copies' intervals) whose midpoint falls inside
a backward phase's host interval, a step. The account's host times are on
the profiler's clock. Tracing slows the host's launches and so adds idle
time, not device work; ``busy`` keeps only the work, read against the
untraced backward's length. None where the port keeps no such account, or
without a device trace."""

import bisect

PHASES = ("generator_backward", "discriminator_backward")


def read(run):
    try:
        from articulatory_tpu_torch import trace
    except ImportError:
        return None
    host, device = run.phase("host"), run.phase("device")
    if host is None or device is None or not device.trace.device:
        return None
    lo = run.cell.traffic["warm_steps"]
    mid = lo + host.counts["steps"]
    untraced = trace.steps(lo, mid).values()
    traced = list(trace.steps(mid, mid + device.counts["steps"]).values())
    b_u, b_t = trace.mean_ms(untraced, PHASES), trace.mean_ms(traced, PHASES)
    if not b_u or b_t is None:
        return None
    spans = sorted((p[n].start_ns / 1e3, p[n].end_ns / 1e3)
                   for p in traced for n in PHASES if n in p)
    starts = [s for s, _ in spans]
    edges = [device.trace.start_us] + [
        t for iv in device.trace.busy_intervals() for t in iv] + [
        device.trace.end_us]
    idle_us = 0.0
    for a, b in zip(edges[::2], edges[1::2]):
        i = bisect.bisect_right(starts, (a + b) / 2) - 1
        if b > a and i >= 0 and spans[i][1] >= (a + b) / 2:
            idle_us += b - a
    busy = b_t - idle_us / 1e3 / len(traced)
    return 100.0 * (b_u - busy) / b_u
