"""A fault planted under the inversion cell's timed path, for the output
check's tests and for calibration: ``narrow_band`` leaves each query one
key fewer on either side (|k - q| <= m - 2: the relative table's first and
last rows and the keep mask's first and last columns cut off), as an
attention kernel with an off-by-one band would. It plants itself in the
port's Transformer layers and returns a function that takes it out.

    python3 portbench/faults_w2a.py --fault narrow_band --workload <cell> \\
        --seeds 1,2,3 [--units N]

runs ``calibrate.py``'s readings of the program with the fault planted,
one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def narrow_band():
    from articulatory_tpu_torch.layers import transformer
    old = transformer.banded_attention

    def narrowed(q, k, v, table, keep=None, p=0.0):
        return old(q, k, v, table[:, 1:-1],
                   None if keep is None else keep[..., 1:-1], p)

    transformer.banded_attention = narrowed
    return lambda: setattr(transformer, "banded_attention", old)


FAULTS = {"narrow_band": narrow_band}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--fault", required=True, choices=sorted(FAULTS))
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--units", type=int, default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.calibrate import calibrate
    from portbench.core import manifest, program
    cell = manifest.cell(args.workload, listed=False)
    dev = program.device("cuda")
    FAULTS[args.fault]()
    for seed in (int(s) for s in args.seeds.split(",")):
        out = calibrate(cell, seed, args.units, False, dev)
        print(json.dumps(dict(out, fault=args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
