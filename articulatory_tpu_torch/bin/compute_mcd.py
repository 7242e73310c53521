#!/usr/bin/env python3
"""Mean MCD between two directories of wav files (port of
``articulatory_tpu/bin/compute_mcd.py``). Files pair by name, less the
``_gen`` suffix the decode appends; each pair's MCD is printed, then the
mean.

    python -m articulatory_tpu_torch.bin.compute_mcd --gen-dir out \\
        --ref-dir ref [--dtw]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from articulatory_tpu_torch.eval.mcd import mel_cepstral_distortion
from articulatory_tpu_torch.utils.io import read_wav


def _key(name: str) -> str:
    base = os.path.splitext(name)[0]
    return base[:-4] if base.endswith("_gen") else base


def _wavs(folder: str) -> dict[str, str]:
    return {_key(f): os.path.join(folder, f) for f in os.listdir(folder)
            if f.endswith(".wav")}


def compute_mcd(gen_dir: str, ref_dir: str, use_dtw: bool = False
                ) -> dict[str, float]:
    """Utterance -> MCD (dB) over the utterances both directories hold."""
    gen, ref = _wavs(gen_dir), _wavs(ref_dir)
    common = sorted(set(gen) & set(ref))
    if not common:
        raise ValueError("no overlapping utterances between the two "
                         "directories")
    mcds = {}
    for k in common:
        a, sr_a = read_wav(gen[k])
        b, sr_b = read_wav(ref[k])
        if sr_a != sr_b:
            raise ValueError(f"{k}: sample-rate mismatch")
        mcds[k] = mel_cepstral_distortion(a, b, sr_a, use_dtw=use_dtw)
    return mcds


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--gen-dir", type=str, required=True)
    parser.add_argument("--ref-dir", type=str, required=True)
    parser.add_argument("--dtw", action="store_true")
    args = parser.parse_args(argv)
    mcds = compute_mcd(args.gen_dir, args.ref_dir, args.dtw)
    for k, v in mcds.items():
        print(f"{k}\t{v:.3f}")
    print(f"mean MCD over {len(mcds)} utterances: "
          f"{np.mean(list(mcds.values())):.3f} dB")


if __name__ == "__main__":
    main()
