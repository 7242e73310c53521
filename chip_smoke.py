#!/usr/bin/env python3
"""Smoke test of articulatory_tpu_torch on one NVIDIA GPU.

Drives the port's main path, E2W HiFi-CAR chunked-autoregressive synthesis at
the full width of ``egs/ema/voc1/conf/e2w_hifigan_car.yaml`` (141 input
channels incl. 128 AR features, channels 512, upsample (5, 4, 2, 2), MRF
kernels (3, 7, 11) x dilations (1, 3, 5), AR 512) with 100-frame chunks,
through its entry points (``load_model`` -> ``ar_loop_batched``, and the
``bin/decode.py`` loop). Weights are random, drawn from ``--seed``, in the
JAX package's layout and carried across by ``jax_params_to_state_dict``.

Phases, each raising on failure:

1. device: the card, its power limit, torch and CUDA versions;
2. build: every ``csrc/*.cu`` with nvcc (one process per source);
3. kernel: ``resblock_pair`` against ``resblock_pair_plain`` (cuDNN convs,
   TF32 off) at all 36 main-path (C, K, d) shapes, with the main path's
   batch (UTTS) and each stage's T per chunk, plus a ragged T,
   in f32 (max error <= 1e-4 of max |y|) and bf16 (<= 2e-2 of max |y|),
   with both timed by CUDA events; and the host's time per launch;
4. slice: ``ar_loop_batched`` over UTTS utterances of SECONDS s
   in f32 and hybrid bf16, with the kernel's launch count held to
   36 x chunks per run, finite outputs of the right length, each of three
   chunks held against the plain pair under the shared carry (f32 max abs
   error <= 1e-6, hybrid <= 5e-3, on tanh outputs), one chunk forward
   timed with the kernel, with plain pairs and with no pairs in turns
   (median and range of ROUNDS), and the decode loop run on a 2-utterance
   .npy dump.

Prints the card's ``nvidia-smi`` name and power limit, one JSON line
``{"kernels": [...]}``, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Per-shape numbers go to ``chiprun_out/chip_smoke.json``. Exits non-zero,
printing no result, without a CUDA device or outside a checkout of the repo.

    python3 chip_smoke.py [--seed 0]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# egs/ema/voc1/conf/e2w_hifigan_car.yaml (generator_params, signal keys);
# batch_max_steps 8000 gives bench.py's 100-frame chunks
GENERATOR_PARAMS = {
    "in_channels": 141, "out_channels": 1, "channels": 512, "kernel_size": 7,
    "upsample_scales": [5, 4, 2, 2], "upsample_kernel_sizes": [10, 8, 4, 4],
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilations": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "use_additional_convs": True, "bias": True,
    "nonlinear_activation": "LeakyReLU",
    "nonlinear_activation_params": {"negative_slope": 0.1},
    "use_weight_norm": True, "use_ar": True, "ar_input": 512,
    "ar_hidden": 256, "ar_output": 128, "final_scale": 80, "extra_art": False,
}
CONFIG = {"sampling_rate": 16000, "hop_size": 80, "dataset_mode": "a2w",
          "format": "npy", "batch_max_steps": 8000, "time_packing": "auto",
          "generator_type": "HiFiGANGenerator",
          "generator_params": GENERATOR_PARAMS}
N_FEATS = 141 - 128
CHUNK_FRAMES = 100
UTTS, SECONDS = 16, 10  # the decode's batch, and each utterance's length
ROUNDS = 5  # chunk-forward timings taken in turns, for median and range
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): fp32 outside the
# tensor cores, bf16 tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# chunk against plain pairs, max abs on tanh outputs: about 40x and 25x the
# readings on an H100 (2.4e-8 f32, 2.0e-4 hybrid)
CHUNK_TOL = {"f32": 1e-6, "hybrid_bf16": 5e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


def numpy_generator_params(gp: dict, seed: int) -> dict:
    """A HiFiGANGenerator param tree in the JAX package's layout: conv
    (K, C_in, C_out) with weight norm (g = ||v||), transposed conv pre-flipped
    with per-input-channel g, dense (in, out); torch-default U(+-1/sqrt(fan_in))."""
    rng = np.random.default_rng(seed)

    def uniform(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def conv(k, c_in, c_out, transpose=False):
        fan_in = (c_out if transpose else c_in) * k
        v = uniform((k, c_in, c_out), fan_in)
        axes = (0, 2) if transpose else (0, 1)
        return {"v": v, "g": np.sqrt((v * v).sum(axis=axes, keepdims=True)),
                "b": uniform((c_out,), fan_in)}

    ch, k = gp["channels"], gp["kernel_size"]
    tree = {"input_conv": conv(k, gp["in_channels"], ch)}
    for i, uk in enumerate(gp["upsample_kernel_sizes"]):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        tree[f"upsample_{i}"] = conv(uk, c_in, c_out, transpose=True)
        for j, (rk, rd) in enumerate(zip(gp["resblock_kernel_sizes"],
                                         gp["resblock_dilations"])):
            tree[f"block_{i}_{j}"] = {f"convs{n}_{d}": conv(rk, c_out, c_out)
                                      for n in (1, 2) for d in range(len(rd))}
    tree["output_conv"] = conv(k, ch // 2 ** len(gp["upsample_scales"]),
                               gp["out_channels"])
    dims = [gp["ar_input"]] + [gp["ar_hidden"]] * 4 + [gp["ar_output"]]
    tree["ar_model"] = {f"fc{i}": {"w": uniform((dims[i], dims[i + 1]), dims[i]),
                                   "b": uniform((dims[i + 1],), dims[i])}
                        for i in range(5)}
    return tree


def time_ms(fn, n: int) -> float:
    """Mean device time of ``fn`` over n calls after one warm-up call, by
    CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def pair_times_ms(b, t, c, k, dtype) -> tuple[float, float]:
    """Least time for one pair by operations (flops over the dtype's peak)
    and by bytes (x in, y out, both kernels and biases once, over HBM
    bandwidth); the bound is the larger."""
    flops = 4.0 * b * t * c * c * k
    size = torch.finfo(dtype).bits // 8
    nbytes = (2.0 * b * t * c + 2.0 * k * c * c + 2.0 * c) * size
    return flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    return smi, torch.cuda.get_device_name(0)


def phase_build(build) -> float:
    start = time.perf_counter()
    libs = build.build_all()
    seconds = time.perf_counter() - start
    log(f"[build] {sorted(libs)} in {seconds:.1f} s")
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {name}: {line.strip()}")
    return seconds


def host_us_per_launch(kernel, n: int = 2000) -> float:
    """Host time of one wrapper call that launches the kernel, at a shape
    so small that the card keeps up with the host: wall time of n calls over
    n."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, w1, w2 = (torch.randn(shape, device="cuda", generator=gen)
                 for shape in ((1, 8, 32), (3, 32, 32), (3, 32, 32)))
    for _ in range(10):
        kernel(x, w1, None, w2, None, dilation=1)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        kernel(x, w1, None, w2, None, dilation=1)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / n * 1e6


def phase_kernel(resblock_pair, resblock_pair_plain, seed: int,
                 batch: int) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scales = GENERATOR_PARAMS["upsample_scales"]
    rows = []
    for stage in range(len(scales)):
        c = GENERATOR_PARAMS["channels"] // 2 ** (stage + 1)
        t = CHUNK_FRAMES * int(np.prod(scales[: stage + 1]))
        for k in GENERATOR_PARAMS["resblock_kernel_sizes"]:
            for d in GENERATOR_PARAMS["resblock_dilations"][0]:
                for dtype in (torch.float32, torch.bfloat16):
                    rows.append(_kernel_case(resblock_pair, resblock_pair_plain,
                                             gen, batch, stage, t, c, k, d,
                                             dtype))
    return rows


def _kernel_case(kernel, plain, gen, batch, stage, t, c, k, d, dtype) -> dict:
    def inputs(length):
        scale = (1.0 / (c * k)) ** 0.5
        x = torch.randn(batch, length, c, device="cuda", generator=gen)
        w1 = torch.randn(k, c, c, device="cuda", generator=gen) * scale
        w2 = torch.randn(k, c, c, device="cuda", generator=gen) * scale
        b1 = torch.randn(c, device="cuda", generator=gen) * 0.1
        b2 = torch.randn(c, device="cuda", generator=gen) * 0.1
        return [a.to(dtype) for a in (x, w1, b1, w2, b2)]

    rel_err = abs_err = 0.0
    for length in (t, t + 37):  # the main path's T, and a ragged one
        args = inputs(length)
        y = kernel(*args, dilation=d)
        ref = plain(*args, dilation=d)
        torch.cuda.synchronize()
        if y.shape != ref.shape or not torch.isfinite(y).all():
            raise AssertionError(f"resblock_pair C{c} K{k} d{d} T{length} "
                                 f"{dtype}: bad output")
        diff = (y.float() - ref.float()).abs().max().item()
        abs_err = max(abs_err, diff)
        rel_err = max(rel_err, diff / ref.float().abs().max().item())
    if rel_err > KERNEL_TOL[dtype]:
        raise AssertionError(f"resblock_pair C{c} K{k} d{d} {dtype}: error "
                             f"{rel_err:.3e} of max |y| > {KERNEL_TOL[dtype]}")
    args = inputs(t)
    n = 10
    # in turns: plain, kernel, kernel, plain
    p1 = time_ms(lambda: plain(*args, dilation=d), n)
    k1 = time_ms(lambda: kernel(*args, dilation=d), n)
    k2 = time_ms(lambda: kernel(*args, dilation=d), n)
    p2 = time_ms(lambda: plain(*args, dilation=d), n)
    ops_ms, bytes_ms = pair_times_ms(batch, t, c, k, dtype)
    return {"stage": stage, "B": batch, "T": t, "C": c, "K": k,
            "dilation": d, "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "kernel_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


@contextlib.contextmanager
def plain_pairs(residual, pair_fn):
    """Run the generator's residual pairs through ``pair_fn`` (the plain
    version) instead of the kernel."""
    saved = residual.resblock_pair
    residual.resblock_pair = pair_fn
    try:
        yield
    finally:
        residual.resblock_pair = saved


def phase_slice(port, seed: int, device_name: str, tmp: str) -> dict:
    inference, residual, resblock_pair, plain, weights, decode = port
    gp = GENERATOR_PARAMS
    ckpt = os.path.join(tmp, "generator.pth")
    torch.save({"model": {"generator": weights.jax_params_to_state_dict(
        numpy_generator_params(gp, seed), gp)}}, ckpt)
    hop, chunk_len = CONFIG["hop_size"], CONFIG["batch_max_steps"]
    n_frames = int(SECONDS * CONFIG["sampling_rate"] / hop)
    n_chunks = -(-n_frames // CHUNK_FRAMES)
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((n_frames, N_FEATS)).astype(np.float32)
          for _ in range(UTTS)]
    modes = {"f32": CONFIG, "hybrid_bf16": dict(CONFIG, generator_params=dict(
        gp, compute_dtype="bfloat16", hybrid_precision=True))}
    models = {}
    for mode, config in modes.items():
        models[mode] = inference.load_model(ckpt, config, device="cuda")
        models[mode].remove_weight_norm()
        inference.ar_loop_batched(models[mode], [x[:CHUNK_FRAMES] for x in xs],
                                  config)  # warm-up: cuDNN plans, allocator

    results, wavs = {}, {}
    resblock_pair.launches = 0
    for i, (mode, config) in enumerate(modes.items()):
        torch.cuda.synchronize()
        start = time.perf_counter()
        outs = inference.ar_loop_batched(models[mode], xs, config)
        seconds = time.perf_counter() - start
        launches = resblock_pair.launches
        expected = 36 * n_chunks * (i + 1)
        if launches != expected:
            raise AssertionError(f"{mode}: resblock_pair launched {launches} "
                                 f"times, expected {expected}")
        for out in outs:
            if out.shape != (n_frames * hop,) or not np.isfinite(out).all():
                raise AssertionError(f"{mode}: output {out.shape} not finite "
                                     f"or not ({n_frames * hop},)")
        wavs[mode] = outs
        results[mode] = {"seconds": seconds,
                         "samples_per_s": UTTS * n_frames * hop / seconds,
                         "chunks": n_chunks, "launches": launches - (
                             36 * n_chunks * i)}
    launches_total = resblock_pair.launches
    for mode, config in modes.items():
        results[mode].update(_chunk_checks(models[mode], xs, wavs[mode],
                                           residual, plain, mode, n_chunks,
                                           chunk_len))
        r = results[mode]
        spans = ", ".join(
            f"{name} {r[key]:.3f} ms [{r[key + '_range'][0]:.3f}, "
            f"{r[key + '_range'][1]:.3f}]" for name, key in (
                ("kernel", "chunk_ms"), ("plain pairs", "chunk_plain_ms"),
                ("no pairs", "chunk_without_pairs_ms")))
        log(f"[slice] {mode}: {UTTS} utts x {SECONDS} s, {n_chunks} chunks "
            f"in {r['seconds']:.3f} s = {r['samples_per_s']:.1f} samples/s on "
            f"{device_name}; resblock_pair launches {r['launches']}; chunk "
            f"max abs err vs plain {r['chunk_max_abs_err']:.3e} (tol "
            f"{CHUNK_TOL[mode]}); chunk forward, median [range] of {ROUNDS}: "
            f"{spans}")

    dump, outdir = os.path.join(tmp, "dump"), os.path.join(tmp, "out")
    os.makedirs(dump)
    for n in range(2):
        np.save(os.path.join(dump, f"utt{n}-feats.npy"), xs[n][:300])
    decode.decode(CONFIG, ckpt, outdir, dumpdir=dump, device="cuda")
    for n in range(2):
        if not os.path.exists(os.path.join(outdir, f"utt{n}_gen.wav")):
            raise AssertionError(f"decode wrote no utt{n}_gen.wav")
    log("[slice] decode: wrote utt0_gen.wav, utt1_gen.wav")
    results["launches_total"] = launches_total
    return results


def _chunk_checks(model, xs, outs, residual, plain, mode, n_chunks,
                  chunk_len) -> dict:
    """Chunks 0, 1 and the last of the batched run, each against a forward
    with the plain pair from the run's own carry; and one chunk forward's
    time with the kernel, with plain pairs and with every pair an identity
    (the time of the rest), taken in turns ROUNDS times: median and range."""
    ar_input = GENERATOR_PARAMS["ar_input"]
    feats = torch.from_numpy(np.stack(xs)).cuda()
    wav = torch.from_numpy(np.stack(outs))[:, :, None].cuda()
    worst = 0.0
    for ci in sorted({0, 1, n_chunks - 1}):
        cin = feats[:, ci * CHUNK_FRAMES:(ci + 1) * CHUNK_FRAMES]
        prev = (torch.zeros(len(xs), ar_input, 1, device="cuda") if ci == 0
                else wav[:, ci * chunk_len - ar_input: ci * chunk_len])
        with plain_pairs(residual, plain):
            ref = model(cin, ar=prev)
        got = wav[:, ci * chunk_len:(ci + 1) * chunk_len]
        err = (got - ref).abs().max().item()
        if not torch.isfinite(ref).all() or err > CHUNK_TOL[mode]:
            raise AssertionError(f"{mode} chunk {ci}: max abs error {err:.3e} "
                                 f"against the plain pair > {CHUNK_TOL[mode]}")
        worst = max(worst, err)
    cin, prev = feats[:, :CHUNK_FRAMES], wav[:, chunk_len - ar_input:chunk_len]
    pairs = {"chunk_ms": residual.resblock_pair, "chunk_plain_ms": plain,
             "chunk_without_pairs_ms": lambda x, *args, **kwargs: x}
    times = {key: [] for key in pairs}
    for _ in range(ROUNDS):
        for key, pair_fn in pairs.items():
            with plain_pairs(residual, pair_fn):
                times[key].append(time_ms(lambda: model(cin, ar=prev), 5))
    out = {"chunk_max_abs_err": worst}
    for key, values in times.items():
        out[key] = float(np.median(values))
        out[key + "_range"] = [min(values), max(values)]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    smi, device_name = phase_device()
    sys.path.insert(0, ROOT)
    from articulatory_tpu_torch import inference
    from articulatory_tpu_torch.bin import decode
    from articulatory_tpu_torch.layers import residual
    from articulatory_tpu_torch.ops import _build
    from articulatory_tpu_torch.ops.resblock_pair import (
        resblock_pair,
        resblock_pair_plain,
    )
    from articulatory_tpu_torch.utils import weights
    from articulatory_tpu_torch.utils.device import set_float32_parity

    set_float32_parity()
    build_seconds = phase_build(_build)
    rows = phase_kernel(resblock_pair, resblock_pair_plain, args.seed, UTTS)
    host_us = host_us_per_launch(resblock_pair)
    log(f"[kernel] host time per launch: {host_us:.2f} us")
    by_dtype = {}
    for dtype in ("float32", "bfloat16"):
        sel = [r for r in rows if r["dtype"] == dtype]
        by_dtype[dtype] = {key: sum(r[key] for r in sel) for key in
                           ("kernel_ms", "plain_ms", "bound_ms", "ops_ms",
                            "bytes_ms")}
        by_dtype[dtype]["max_abs_err"] = max(r["max_abs_err"] for r in sel)
        by_dtype[dtype]["max_rel_err"] = max(r["max_rel_err"] for r in sel)
        log(f"[kernel] {dtype}: 36 main-path shapes at B={UTTS}: "
            f"kernel {by_dtype[dtype]['kernel_ms']:.3f} ms, plain "
            f"{by_dtype[dtype]['plain_ms']:.3f} ms, bound "
            f"{by_dtype[dtype]['bound_ms']:.3f} ms, max rel err "
            f"{by_dtype[dtype]['max_rel_err']:.2e}")
    with tempfile.TemporaryDirectory() as tmp:
        slice_results = phase_slice(
            (inference, residual, resblock_pair, resblock_pair_plain, weights,
             decode), args.seed, device_name, tmp)

    f32 = by_dtype["float32"]
    entry = {
        "name": "resblock_pair", "route": "cuda",
        "source": "articulatory_tpu_torch/csrc/resblock_pair.cu",
        "replaces": "articulatory_tpu/ops/pallas/resblock.py:98",
        "launches": slice_results["launches_total"],
        # the 36 main-path shapes of one chunk forward, float32
        "max_abs_err": f32["max_abs_err"], "ms": f32["kernel_ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": ("operations" if f32["ops_ms"] >= f32["bytes_ms"]
                     else "bytes"),
        "library_ms": None,
        "bf16_ms": by_dtype["bfloat16"]["kernel_ms"],
        "bf16_plain_ms": by_dtype["bfloat16"]["plain_ms"],
        "bf16_bound_ms": by_dtype["bfloat16"]["bound_ms"],
        "bf16_max_abs_err": by_dtype["bfloat16"]["max_abs_err"],
        "host_us_per_launch": host_us,
    }
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "build_seconds": build_seconds,
                   "kernel_shapes": rows, "kernel_totals": by_dtype,
                   "slice": slice_results, "kernels": [entry]}, f, indent=1)
    log(json.dumps({"kernels": [entry]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
