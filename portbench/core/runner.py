"""One run of one cell: set-up, warm-up, the measured window, the output
check, the metrics and the result line."""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import torch

from portbench.core import imports, manifest
from portbench.core.trace import PHASES, Trace, Window


@dataclasses.dataclass
class Phase:
    """One phase of a traced run's window (``trace.PHASES``)."""
    counts: dict        # the driver's counts over the phase
    seconds: float      # its length by the host clock
    trace: Trace | None


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: manifest.Cell
    counts: dict        # the driver's counts over the window
    seconds: float      # the window's length by the host clock
    setup_s: float      # process start to the window's start
    phases: dict        # name -> Phase, in a traced run

    def phase(self, name: str) -> Phase | None:
        return self.phases.get(name)


def run_cell(cell: manifest.Cell, bench: dict, seed: int, seconds: float,
             traced: bool, dev: torch.device, t0: float) -> dict | None:
    """The result of one run, or None where JAX or the JAX package was
    loaded (named on stderr by the caller). ``t0`` is the process's start
    by ``time.perf_counter``."""
    driver = manifest.load_module("drivers", cell.traffic["driver"]).Driver(
        cell, seed, dev)
    built = time.perf_counter()
    driver.warm()
    print(f"set-up: {built - t0:.3f} s to the driver built, "
          f"{time.perf_counter() - built:.3f} s of warm-up",
          file=sys.stderr)
    # the output check follows the window's first units
    j, phases, setup_s, measured = 0, {}, None, 0.0
    names = PHASES if traced else (None,)
    for name in names:
        with Window(name, dev) as window:
            if setup_s is None:
                setup_s = window.start - t0
            first = j
            while True:
                driver.unit(j, name == "ops")
                j += 1
                if (window.elapsed() >= seconds / len(names)
                        and j >= driver.check_units()):
                    break
        measured += window.seconds
        if traced:
            phases[name] = Phase(driver.counts(first, j), window.seconds,
                                 window.trace)
            print(f"phase {name}: {j - first} units in {window.seconds:.3f}"
                  f" s", file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    counts = driver.counts(0, j)
    driver.free()
    checks = driver.check()
    # a gap that is NaN compares false: not correct
    correct = all(c["value"] <= c["limit"] for c in checks)
    run = Run(cell, counts, measured, setup_s, phases)
    metrics = {}
    for m in manifest.metrics_for(bench, cell.name, traced):
        value = manifest.load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": counts["attempted"],
              "failed": counts["failed"], "metrics": metrics,
              "device": device}
    if traced:
        device["busy_s"] = phases["device"].trace.busy_s
        device["window_s"] = phases["device"].trace.window_s
        result["breakdown"] = phases["ops"].trace.breakdown()
    # the numbers compared, last: a gap that is not finite as a string
    result["check"] = {c["name"]: {"value": c["value"] if math.isfinite(
        c["value"]) else str(c["value"]), "limit": c["limit"]}
        for c in checks}
    if imports.forbidden_loaded():
        return None
    return result
