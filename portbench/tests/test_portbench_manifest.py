"""BENCHMARK.json against the benchmark's contract, and every name it
gives found as a file."""

import json
import re

import pytest

from portbench.core import manifest

BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|channels"
                   r"|head|expansion|experts_per_tok|_dim$|_rank$)")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


@pytest.mark.parametrize("name", [e["name"] for e in BENCH["configs"]
                                  + BENCH["workloads"] + METRICS]
                         + [w[k] for w in BENCH["workloads"]
                            for k in ("config", "traffic")])
def test_names(name):
    assert NAME.match(name)


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metric_fields():
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 0 < len(m["layer"]) <= 200 and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found(cell):
    c = manifest.cell(cell, BENCH)
    assert c.chips == 1
    assert (manifest.BENCH / "drivers"
            / f"{c.traffic['driver']}.py").exists()
    reported = manifest.metrics_for(BENCH, cell, False)
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert manifest.metrics_for(BENCH, cell, True)
    for m in reported + manifest.metrics_for(BENCH, cell, True):
        assert hasattr(manifest.load_module("metrics", m["name"]), "read")


def test_per_layer_cells_report_what_they_move():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            names = {e["name"] for e in manifest.metrics_for(BENCH, cell,
                                                             False)}
            assert m["moves"] in names, (m["name"], cell)


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_configs(config):
    assert config["file"].startswith("portbench/configs/")
    data = json.loads((manifest.ROOT / config["file"]).read_text())
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert not any(WIDTH.search(k) for k in config["reduced"])
    assert data["precision"] in manifest.PRECISIONS


def test_every_config_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_check_fits_the_day():
    """A full check with 24 cells at this run length fits 43,200 s."""
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert 1 <= BENCH["run_seconds"] <= 51 and total <= 43200
