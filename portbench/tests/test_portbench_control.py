"""The output check fails what it must: the reference in the control
precision in the program's place, and the program broken underneath the
timed path (a carry or a state left unchanged, half of the batch left out,
an answer altered where it is made), each at a tiny size on the CPU with
the cell's own limits."""

import time

import pytest

from conftest import CPU, tiny
from portbench import faults
from portbench.core import manifest, runner

BENCH = manifest.benchmark()
DECODE = ["ema-decode-b64", "mri-decode-hybrid-b16", "ema-single-b1"]


def run(cell) -> dict:
    return runner.run_cell(cell, BENCH, 2 ** 31 + 21, 0.3, False, CPU,
                           time.perf_counter())


@pytest.mark.parametrize("name", DECODE + ["ema-train-b64"])
def test_control_fails(name):
    cell = tiny(name)
    driver = manifest.load_module("drivers", cell.traffic["driver"]).Driver(
        cell, 5, CPU)
    driver.warm()
    for j in range(driver.check_units()):
        driver.unit(j, False)
    driver.free()
    assert all(c["value"] <= c["limit"] for c in driver.check())
    driver.serve_reference(cell.spec["control"])
    assert any(c["value"] > c["limit"] for c in driver.check())


@pytest.mark.parametrize("fault", sorted(faults.DECODE))
@pytest.mark.parametrize("name", DECODE)
def test_decode_faults(name, fault):
    if fault == "half_batch" and name == "ema-single-b1":
        pytest.skip("one utterance a call has no half to leave out")
    undo = faults.DECODE[fault]()
    try:
        assert not run(tiny(name))["correct"]
    finally:
        undo()


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_faults(fault):
    undo = faults.TRAIN[fault]()
    try:
        assert not run(tiny("ema-train-b64"))["correct"]
    finally:
        undo()


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_faults_after_setup(fault):
    """A fault that starts with the window, after the set-up steps that
    the check also reads, fails the window's numbers."""
    cell = tiny("ema-train-b64")
    driver = manifest.load_module("drivers", cell.traffic["driver"]).Driver(
        cell, 7, CPU)
    driver.warm()
    undo = faults.TRAIN[fault]()
    try:
        for j in range(driver.check_units()):
            driver.unit(j, False)
    finally:
        undo()
    driver.free()
    failed = {c["name"] for c in driver.check() if not c["value"]
              <= c["limit"]}
    assert failed and all(n.startswith("window_") for n in failed)
