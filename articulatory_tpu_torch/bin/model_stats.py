#!/usr/bin/env python3
"""Latency against input length for a generator config (port of
``articulatory_tpu/bin/model_stats.py``).

Builds the config's generator with random weights (seed 0; weight norm
frozen, as the decode does), prints its parameter count (the JAX
package's, leaf for leaf) and, for each ``--lengths`` frame count, the
latency of one forward over ``--batch`` utterances of zeros and its
real-time factor. On a card each length is timed with CUDA events after a
warm-up forward, in the generator's configured precision
(``compute_dtype``, ``hybrid_precision``); on the CPU by the host clock.
AR generators get a zero carry; Parallel WaveGAN and StyleMelGAN draw
their noise from a seeded generator.

    python -m articulatory_tpu_torch.bin.model_stats --config conf.yaml \\
        [--lengths 100 200 400] [--iters 5] [--batch 1] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from articulatory_tpu_torch.config import fix_generator_params, load_config
from articulatory_tpu_torch.models import (
    NOISE_DRIVEN_GENERATORS,
    RNG_GENERATORS,
    build_model,
)
from articulatory_tpu_torch.utils.device import resolve_device


def model_stats(config: dict, lengths, iters: int = 5, batch: int = 1,
                device: str | None = None) -> dict:
    """Print and return the parameter count and, per length, the latency
    in ms and the RTF of one forward."""
    dev = resolve_device(device)
    gen_type = config["generator_type"]
    gp = fix_generator_params(config["generator_params"])
    model = build_model(gen_type, gp).to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"generator params: {n_params:,}")
    model.remove_weight_norm()
    use_ar = gp.get("use_ar", False)
    in_feats = gp["in_channels"] - (gp.get("ar_output", 128) if use_ar else 0)
    out_channels = gp.get("out_channels", 1)
    ar_len = gp.get("ar_input", 512)
    if config.get("dataset_mode") == "w2a":  # a carry of frames
        ar_len //= out_channels
    sr = config.get("sampling_rate", 16000)
    hop = config.get("hop_size", 256)
    noise = torch.Generator(dev).manual_seed(0)

    def forward(c, ar):
        if gen_type in NOISE_DRIVEN_GENERATORS or gen_type in RNG_GENERATORS:
            return model.inference(c, noise)
        return model(c) if ar is None else model(c, ar)

    rows = []
    with torch.inference_mode():
        for t in lengths:
            c = torch.zeros((batch, t, in_feats), device=dev)
            ar = (torch.zeros((batch, ar_len, out_channels), device=dev)
                  if use_ar else None)
            forward(c, ar)  # warm-up: first-use host work, cuDNN plans
            if dev.type == "cuda":
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                torch.cuda.synchronize()
                start.record()
                for _ in range(iters):
                    forward(c, ar)
                end.record()
                end.synchronize()
                per_call = start.elapsed_time(end) / 1e3 / iters
            else:
                begin = time.perf_counter()
                for _ in range(iters):
                    forward(c, ar)
                per_call = (time.perf_counter() - begin) / iters
            audio_sec = t * hop / sr * batch
            rows.append({"frames": t, "latency_ms": per_call * 1e3,
                         "rtf": per_call / audio_sec})
            print(f"len={t:6d} frames  ({t * hop / sr:6.2f}s audio)  "
                  f"latency={per_call * 1e3:8.2f} ms  "
                  f"RTF={per_call / audio_sec:.5f}")
    return {"params": n_params, "lengths": rows}


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--lengths", type=int, nargs="+",
                        default=[50, 100, 200, 400, 800])
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    model_stats(load_config(args.config), args.lengths, args.iters,
                args.batch, args.device)


if __name__ == "__main__":
    main()
