"""Shared by the benchmark's tests: cells shrunk to a size the CPU runs in
seconds (every width cut; the structure, chunking and losses kept), and
the cells held out of ``BENCHMARK.json`` with the metrics they report."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.core import manifest  # noqa: E402

CPU = torch.device("cpu")
BENCH = manifest.benchmark()
# cells whose workload file says why BENCHMARK.json does not list them
HELD = sorted(p.stem for p in (manifest.BENCH / "workloads").glob("*.json")
              if "held" in manifest.read_json(p))
HELD_METRICS = {
    "decode_samples_per_s": ("ema-decode-b64", "mri-decode-hybrid-b16"),
    "utt_latency_p95_ms": ("ema-single-b1",),
    "mfu.decode": ("ema-decode-b64", "mri-decode-hybrid-b16"),
    "pair_roofline.decode": ("ema-decode-b64", "mri-decode-hybrid-b16"),
    "device_idle.decode": ("ema-decode-b64", "mri-decode-hybrid-b16"),
    "mfu.single": ("ema-single-b1",),
    "utt_latency_p50_ms.single": ("ema-single-b1",),
    "device_idle.single": ("ema-single-b1",)}
E2E = ("decode_samples_per_s", "utt_latency_p95_ms")


def with_held() -> dict:
    """BENCHMARK.json with the held cells listed, on one chip, each with
    the metrics its readers give."""
    bench = json.loads(json.dumps(BENCH))
    for name in HELD:
        spec = manifest.read_json(manifest.BENCH / "workloads"
                                  / f"{name}.json")
        bench["workloads"].append({"name": name, "config": spec["config"],
                                   "traffic": spec["traffic"], "chips": 1})
    for name, cells in HELD_METRICS.items():
        group = "end_to_end" if name in E2E else "per_layer"
        bench[group].append({"name": name, "unit": "x",
                             "workloads": list(cells)})
    return bench


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card")


def tiny(name: str) -> manifest.Cell:
    """Cell ``name`` at a tiny size: 2 upsampling stages of 2, channels 32,
    a carry of 32 samples, 16-frame chunks, small discriminators and mel."""
    cell = manifest.cell(name, listed=False)
    m = cell.config["model"]
    gp = m["generator_params"]
    feat = gp["in_channels"] - gp["ar_output"]
    gp.update(channels=32, upsample_scales=[2, 2],
              upsample_kernel_sizes=[4, 4], ar_input=32, ar_hidden=16,
              ar_output=8, in_channels=feat + 8)
    m.update(hop_size=4, batch_max_steps=64, sampling_rate=400)
    dp = m["discriminator_params"]
    dp["scale_discriminator_params"].update(channels=16,
                                            max_downsample_channels=32)
    dp["period_discriminator_params"].update(channels=4,
                                             max_downsample_channels=16)
    m["mel_loss_params"].update(fs=400, fft_size=32, hop_size=8, num_mels=8,
                                fmax=200)
    t = cell.traffic
    for key, value in (("batch", 3), ("block", 4), ("pool", 2)):
        if key in t:
            t[key] = min(t[key], value)
    if t["driver"] == "train_step":
        t["batch"] = 2
    return cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
