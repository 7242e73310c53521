#!/usr/bin/env python3
"""Time one ``chip_smoke.py`` phase of two checkouts in turns on the card,
each run in a process of its own, so that a change is read against its
parent on one machine (host-bound phases spread 1.5-2x from one machine's
session to another's, so readings from different sessions do not compare).

    python -m articulatory_tpu_torch.bin.ab_phase --phase w2a --rounds 3 \\
        --out chiprun_out/ab_w2a.json PARENT_DIR CHANGE_DIR

Each directory holds a whole checkout (e.g. unpacked from ``git
archive``); its own ``chip_smoke.py`` and ``articulatory_tpu_torch`` run,
in the order parent, change, change, parent, ``--rounds`` times. Phases:
``w2a``, the full-utterance BiGRU at 13-d and 1024-d (samples/s, device
ops and the device's busy share over one forward); ``hybrid-train``, the
EMA training steps of ``[hybrid-train]`` (the f32, hybrid and hybrid +
bf16-discriminator step medians in turns and their parts, after the
kernels' build and the phase's synthetic corpus; both checkouts'
``chip_smoke.py`` must define ``training_port``). Prints a line a run and
writes every run's numbers to ``--out``. Needs one card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile

# phase -> (chip_smoke function, the port modules its ``port`` dict holds)
PHASES = {"w2a": ("phase_w2a", {
    "inference": "articulatory_tpu_torch.inference",
    "weights": "articulatory_tpu_torch.utils.weights"}),
    "hybrid-train": ("phase_hybrid_train", {})}


def _hybrid_train(smoke, seed: int) -> dict:
    """[hybrid-train] with the port of ``chip_smoke.training_port()``; its
    step medians and parts by variant."""
    from articulatory_tpu_torch.ops import _build

    _build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        smoke._write_corpus(tmp, seed)
        result = smoke.phase_hybrid_train(smoke.training_port(), seed, tmp)
    return {k: {key: v[key] for key in (
        "step_ms_median", "generator_fwd_bwd_ms", "regeneration_ms",
        "discriminator_fwd_bwd_ms")} for k, v in result["turns"].items()}


def run_child(phase: str, tree: str, seed: int) -> None:
    """Run ``phase`` of the checkout ``tree`` in this process and print its
    numbers on a line starting with ``RESULT``."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    smoke = importlib.import_module("chip_smoke")
    smi, device_name = smoke.phase_device()
    fn_name, modules = PHASES[phase]
    inference = importlib.import_module("articulatory_tpu_torch.inference")
    if not inference.__file__.startswith(tree):
        raise RuntimeError(f"{inference.__file__} is not under {tree}")
    importlib.import_module(
        "articulatory_tpu_torch.utils.device").set_float32_parity()
    if phase == "hybrid-train":
        summary = _hybrid_train(smoke, seed)
    else:
        port = {k: importlib.import_module(v) for k, v in modules.items()}
        with tempfile.TemporaryDirectory() as tmp:
            result = getattr(smoke, fn_name)(port, seed, device_name, tmp)
        summary = {str(k): {"samples_per_s": v["samples_per_s"],
                            "seconds": v["seconds"],
                            "device_ops": v["profile"]["device_ops"],
                            "busy_share": v["profile"]["busy_share"]}
                   for k, v in result.items()}
    print("RESULT " + json.dumps({"smi": smi, "phase": phase,
                                  "numbers": summary}), flush=True)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("parent")
    parser.add_argument("change")
    parser.add_argument("--phase", choices=sorted(PHASES), default="w2a")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None)
    parser.add_argument("--timeout", type=float, default=300.0,
                        help="seconds a run may take")
    parser.add_argument("--child", action="store_true",
                        help="run the phase of PARENT here (internal)")
    args = parser.parse_args(argv)
    if args.child:
        run_child(args.phase, args.parent, args.seed)
        return 0
    runs, failed = [], False
    for which in ("parent", "change", "change", "parent") * args.rounds:
        tree = getattr(args, which)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, tree,
             "--child", "--phase", args.phase, "--seed", str(args.seed)],
            capture_output=True, text=True, timeout=args.timeout)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            failed = True
            print(f"{which}: exit {proc.returncode}\n{proc.stdout[-2000:]}\n"
                  f"{proc.stderr[-3000:]}", flush=True)
            runs.append({"tree": which, "exit": proc.returncode})
            continue
        run = dict(json.loads(lines[0][len("RESULT "):]), tree=which)
        runs.append(run)
        print(which, run["numbers"], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
