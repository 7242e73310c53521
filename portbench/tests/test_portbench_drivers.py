"""Each driver through a whole run at a tiny size on the CPU (the kernels'
plain versions), traced and untraced, in the listed cells and the held
ones; the command itself refuses to run without a card."""

import subprocess
import sys
import time

import pytest
import torch

from conftest import CPU, ROOT, tiny, with_held
from portbench.core import manifest, runner

BENCH = with_held()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("traced", [False, True], ids=["e2e", "trace"])
@pytest.mark.parametrize("name", CELLS)
def test_run(name, traced):
    result = runner.run_cell(tiny(name), BENCH, 2 ** 31 + 11, 0.5, traced,
                             CPU, time.perf_counter())
    assert result["correct"], result["check"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "check"
    names = {m["name"] for m in manifest.metrics_for(BENCH, name, traced)}
    if traced:
        # no device on the CPU: the device readers find nothing to read
        assert set(result["metrics"]) <= names
        assert result["device"]["window_s"] > 0
        # the untraced phase's rates and times are there without a device
        assert {n for n in names if n.startswith(("mfu", "utt_"))} <= set(
            result["metrics"])
    else:
        assert set(result["metrics"]) == names
        assert all(m["value"] > 0 for m in result["metrics"].values())


def test_same_seed_same_inputs():
    from portbench.core import seeds, traffic
    cell = tiny("ema-decode-b64")
    a = traffic.feature_pool(5, 2, 30, 13, CPU)
    assert (a == traffic.feature_pool(5, 2, 30, 13, CPU)).all()
    f = traffic.stratified_frames(2 ** 33, 3, 64, cell.traffic, cell.model)
    assert (f == traffic.stratified_frames(2 ** 33, 3, 64, cell.traffic,
                                           cell.model)).all()
    # one length a stratum: every seed draws the same spread
    lo, hi = cell.traffic["seconds"]
    fps = traffic.frames_per_second(cell.model)
    step = (hi - lo) * fps / 64
    for k, frames in enumerate(sorted(f)):
        assert lo * fps + k * step - 1 <= frames <= lo * fps + (k + 1) * step
    w = seeds.make_weights({"a.weight_v": (4, 3, 5), "a.weight_g": (4, 1, 1),
                            "a.bias": (4,)}, 9, CPU, "t")
    assert w["a.weight_v"].abs().max() <= 15 ** -0.5
    gain = w["a.weight_g"].flatten() / w["a.weight_v"].square().sum(
        (1, 2)).sqrt()
    assert ((gain >= 0.75) & (gain <= 1.25)).all()


def test_command_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "ema-train-b64", "--seed", "1", "--seconds", "1"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""


@pytest.mark.gpu
def test_command_on_the_card(card, tmp_path):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "ema-train-b64", "--seed", "3", "--seconds", "2"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json
    assert json.loads(proc.stdout.splitlines()[-1])["correct"]
