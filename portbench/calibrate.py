"""The readings that the limits of the output check are set from (not run
by the benchmark's runs).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--units N] [--control [--precision P]] [--fault NAME]

For each seed, in one process: the cell's set-up, ``--units`` units of its
traffic (default: what a run checks), and the output check of what the
program served (the lower reading). With ``--control`` the reference in
the workload's ``control`` precision is then put in the program's place
and checked the same way (the upper reading); ``--precision`` reads
another control. ``--fault`` plants one of ``faults.py``'s faults under
the timed path first. One JSON line a seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--units", type=int, default=0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--precision")
    parser.add_argument("--fault")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import faults
    from portbench.core import manifest, program
    cell = manifest.cell(args.workload, listed=False)
    dev = program.device("cuda")
    if args.fault:
        {**faults.DECODE, **faults.TRAIN}[args.fault]()
    for seed in (int(s) for s in args.seeds.split(",")):
        out = calibrate(cell, seed, args.units, args.control, dev,
                        args.precision)
        print(json.dumps(dict(out, fault=args.fault)), flush=True)
    return 0


def calibrate(cell, seed: int, units: int, control: bool, dev,
              precision: str | None = None) -> dict:
    from portbench.core import manifest
    start = time.perf_counter()
    driver = manifest.load_module("drivers", cell.traffic["driver"]).Driver(
        cell, seed, dev)
    driver.warm()
    for j in range(units or driver.check_units()):
        driver.unit(j, False)
    driver.free()
    out = {"cell": cell.name, "seed": seed,
           "program": {c["name"]: c["value"] for c in driver.check()}}
    if control:
        precision = precision or cell.spec["control"]
        driver.serve_reference(precision)
        out["control"] = {"precision": precision, **{
            c["name"]: c["value"] for c in driver.check()}}
    out["seconds"] = time.perf_counter() - start
    return out


if __name__ == "__main__":
    sys.exit(main())
