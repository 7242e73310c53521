"""The benchmark's files, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics. Each
cell ``<cell>`` has ``workloads/<cell>.json`` (its configuration, traffic,
precision and the limits of its output check); the configuration is
``configs/<config>.json`` and the traffic mix ``traffic/<traffic>.json``,
whose ``driver`` names ``drivers/<driver>.py``. Every metric ``<name>`` is
read by ``metrics/<name>.py``. Adding any of these is adding a file.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
PRECISIONS = ("f32", "hybrid", "bf16")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict      # configs/<config>.json
    traffic_name: str
    traffic: dict     # traffic/<traffic>.json
    spec: dict        # workloads/<cell>.json

    @property
    def model(self) -> dict:
        """The recipe's configuration as it is run."""
        return self.config["model"]

    @property
    def precision(self) -> str:
        return self.config["precision"]


def cell(name: str, bench: dict | None = None, listed: bool = True) -> Cell:
    """The cell ``name`` with its files; its workload file must name the
    configuration and traffic that ``BENCHMARK.json`` gives it. With
    ``listed`` False, a cell that ``BENCHMARK.json`` does not list (one
    held back, whose workload file says why) is taken from its workload
    file on one chip, for tests and calibration."""
    bench = benchmark() if bench is None else bench
    spec = read_json(BENCH / "workloads" / f"{name}.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries and listed:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}")
    entry = entries[0] if entries else dict(spec, chips=1)
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{spec[key]!r}, BENCHMARK.json {entry[key]!r}")
    config = read_json(BENCH / "configs" / f"{entry['config']}.json")
    if spec["precision"] != config["precision"]:
        raise ValueError(f"workloads/{name}.json runs {spec['precision']}, "
                         f"its configuration states {config['precision']}")
    return Cell(name=name, chips=int(entry["chips"]),
                config_name=entry["config"], config=config,
                traffic_name=entry["traffic"],
                traffic=read_json(BENCH / "traffic"
                                  / f"{entry['traffic']}.json"),
                spec=spec)


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones. A metric with ``workloads``
    is reported in those cells; an end-to-end metric without it in every
    cell, a per-layer metric without it in every cell that reports the
    end-to-end metric it moves."""
    def listed(metric):
        return "workloads" not in metric or cell_name in metric["workloads"]

    end_to_end = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return end_to_end
    reported = {m["name"] for m in end_to_end}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, loaded by path
    (metric names hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
