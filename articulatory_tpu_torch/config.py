"""YAML config handling (port of ``articulatory_tpu/config.py``).

The dumped ``config.yml`` beside checkpoints is the inference-time contract.
The top-level ``time_packing`` key (a TPU layout option) is accepted and
ignored. ``yaml`` is imported only when a file is read.
"""

from __future__ import annotations


def load_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.load(f, Loader=yaml.Loader)


def fix_generator_params(params: dict) -> dict:
    """Back-compat: fix the 'upsample_kernal_sizes' typo (reference
    utils/utils.py:330-334)."""
    return {k.replace("upsample_kernal_sizes", "upsample_kernel_sizes"): v
            for k, v in params.items()}
