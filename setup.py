#!/usr/bin/env python3
"""Setup articulatory_tpu package (console scripts mirror the reference's
setup.py:53-61 entry points, with an ``articulatory-tpu-`` prefix)."""

from setuptools import find_packages, setup

setup(
    name="articulatory_tpu",
    version="0.1.0",
    description="TPU-native articulatory speech processing "
                "(synthesis + inversion) framework",
    packages=find_packages(include=["articulatory_tpu*"]),
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "chex", "numpy", "scipy", "h5py", "pyyaml",
        "scikit-learn", "tqdm", "tensorboardX", "matplotlib",
    ],
    entry_points={
        "console_scripts": [
            "articulatory-tpu-preprocess=articulatory_tpu.bin.preprocess:main",
            "articulatory-tpu-compute-statistics=articulatory_tpu.bin.compute_statistics:main",
            "articulatory-tpu-normalize=articulatory_tpu.bin.normalize:main",
            "articulatory-tpu-train=articulatory_tpu.bin.train:main",
            "articulatory-tpu-decode=articulatory_tpu.bin.decode:main",
            "articulatory-tpu-compute-mcd=articulatory_tpu.bin.compute_mcd:main",
            "articulatory-tpu-model-stats=articulatory_tpu.bin.model_stats:main",
            "articulatory-tpu-convert-checkpoint=articulatory_tpu.bin.convert_checkpoint:main",
        ] + [
            # the PyTorch port's entry points (articulatory_tpu_torch/bin)
            f"articulatory-tpu-torch-{name.replace('_', '-')}="
            f"articulatory_tpu_torch.bin.{name}:main"
            for name in ("preprocess", "compute_statistics", "normalize",
                         "train", "decode", "compute_mcd", "model_stats",
                         "convert_checkpoint", "predict_wav", "predict_ema")
        ],
    },
)
