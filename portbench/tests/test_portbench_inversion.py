"""The inversion training cell at a tiny size on the CPU (the banded
attention's plain version): the driver through a whole run, traced and
untraced; the reference against the port in float64; the check failing
its bf16 control and the narrowed band of ``faults_w2a.py``; the FLOP
count and the attention's bound against counts worked by hand."""

import time

import pytest
import torch

from conftest import CPU
from portbench import faults_w2a, flops_w2a
from portbench.core import manifest, peaks, runner
from portbench.kernels import banded_attention

BENCH = manifest.benchmark()
CELL = "w2a-transformer-train-b32"


def tiny() -> manifest.Cell:
    """The cell at hidden 16 (8 heads of 2), 2 layers, 12 input features, 4
    outputs, batch 2 x 240 rows: the relative window of 100 and the
    dropout of 0.2 kept, so the band is cut at both ends."""
    cell = manifest.cell(CELL)
    m = cell.config["model"]
    m["generator_params"].update(in_channels=12, out_channels=4,
                                 hidden_dim=16, elayers=2)
    m["batch_max_steps"] = 240
    cell.traffic["batch"] = 2
    return cell


def run(cell, traced=False, seed=2 ** 31 + 11) -> dict:
    return runner.run_cell(cell, BENCH, seed, 0.3, traced, CPU,
                           time.perf_counter())


@pytest.mark.parametrize("traced", [False, True], ids=["e2e", "trace"])
def test_run(traced):
    result = run(tiny(), traced)
    assert result["correct"], result["check"]
    assert result["attempted"] > 0 and result["failed"] == 0
    names = {m["name"] for m in manifest.metrics_for(BENCH, CELL, traced)}
    if traced:
        # no device: the kernels' readers find nothing, the host's rate does
        assert "mfu.w2a" in result["metrics"]
        assert set(result["metrics"]) <= names
    else:
        assert set(result["metrics"]) == names
        assert all(m["value"] > 0 for m in result["metrics"].values())


def test_reference_matches_port_in_float64():
    """The program's check at float64 against the reference in float64: the
    same weights, batches and dropout masks give the same losses, first
    gradients and changes to round-off (the norms compared are taken in
    float32, a relative 1e-7 apart at most)."""
    cell = tiny()
    cell.config["precision"] = "f64"
    driver = manifest.load_module("drivers", "train_inversion").Driver(
        cell, 3, CPU)
    driver.state.generator.double()
    batch = driver.batch
    driver.batch = lambda j: {"x": (batch(j)["x"][0].double(),),
                              "y": batch(j)["y"].double()}
    driver.params = {k: v.double() for k, v in driver.params.items()}
    driver.warm()
    for j in range(driver.check_units()):
        driver.unit(j, False)
    driver.free()
    for check in driver.check():
        assert check["value"] < 1e-6, check


def test_control_fails():
    cell = tiny()
    driver = manifest.load_module("drivers", "train_inversion").Driver(
        cell, 5, CPU)
    driver.warm()
    for j in range(driver.check_units()):
        driver.unit(j, False)
    driver.free()
    assert all(c["value"] <= c["limit"] for c in driver.check())
    driver.serve_reference(cell.spec["control"])
    assert any(c["value"] > c["limit"] for c in driver.check())


@pytest.mark.parametrize("fault", sorted(faults_w2a.FAULTS))
def test_faults(fault):
    undo = faults_w2a.FAULTS[fault]()
    try:
        assert not run(tiny())["correct"]
    finally:
        undo()


def test_flops_by_hand():
    """A 240-row window at the tiny widths, by hand: the band holds
    199 L - 100 x 99 (query, key) pairs."""
    gp = tiny().model["generator_params"]
    length = 240
    front = (2 * 3 * 12 * 16 + 2 * 3 * 16 * 16 + 2 * 12 * 16
             + 2 * (2 * 3 * 16 * 16 + 2 * 3 * 16 * 16))
    outer = 2 * 16 * 16 + 2 * 16 * 4
    pairs = 199 * length - 100 * 99
    layer = length * (4 * 2 * 16 * 16 + 2 * 2 * 16 * 3072) + 3 * 2 * 16 * pairs
    assert flops_w2a.band_pairs(length) == pairs
    assert flops_w2a.forward_flops(gp, length) == (
        length * (front + outer) + 2 * layer)
    assert flops_w2a.train_step_flops(tiny().model, 2) == (
        3 * 2 * flops_w2a.forward_flops(gp, length))


def test_published_step_flops():
    """The cell as it runs: about 116 MFLOP a row forward, of which the
    banded attention about 5.5."""
    model = manifest.cell(CELL).model
    gp = model["generator_params"]
    rows = model["batch_max_steps"]
    assert flops_w2a.forward_flops(gp, rows) / rows == pytest.approx(
        116e6, rel=0.02)
    assert 6 * flops_w2a.attention_flops(gp, rows) / rows == pytest.approx(
        5.5e6, rel=0.05)


def test_attention_bound_by_hand():
    """B 32, H 8, L 2000, d 96, m 100: the operations bound (18 FLOPs a
    pair and d, three TF32 products) holds over the bytes bound."""
    pairs = 199 * 2000 - 100 * 99
    flops = 18.0 * 32 * 8 * pairs * 96
    nbytes = (8 * 32 * 8 * 2000 * 96 * 4 + 2 * 8 * 199 * 96 * 4
              + 32 * 8 * 2000 * 199)
    assert flops * 3 / peaks.TF32_FLOPS > nbytes / peaks.HBM_BYTES
    assert banded_attention.bound_s(32, 8, 2000, 96, 100) == pytest.approx(
        3 * flops / peaks.TF32_FLOPS, rel=1e-12)
