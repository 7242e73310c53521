"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The cell, its configuration, traffic and
metrics are found by name (``BENCHMARK.json``, ``portbench/README.md``).
Without a card, or with fewer than the cell asks for, it exits with 2 and
prints no result; where JAX or the JAX package is loaded once the window
has closed, with 3. The last lines of stderr are the output check's
numbers beside their limits; the last line of stdout is the result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every compile cache at a fixed path inside the checkout
CACHE = ROOT / ".bench_cache"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.core import imports, manifest, program, runner

    bench = manifest.benchmark()
    cell = manifest.cell(args.workload, bench)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import articulatory_tpu_torch
    if ROOT not in Path(articulatory_tpu_torch.__file__).resolve().parents:
        print(f"portbench: the port was imported from "
              f"{articulatory_tpu_torch.__file__}, not from this checkout",
              file=sys.stderr)
        return 2
    result = runner.run_cell(cell, bench, args.seed, args.seconds,
                             bool(args.trace), program.device("cuda"), T0)
    if result is None:
        print(f"portbench: loaded after the window: "
              f"{', '.join(imports.forbidden_loaded())}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
