"""articulatory_tpu_torch: the PyTorch/CUDA port of articulatory_tpu.

It carries the HiFi-CAR decode path of the EMA and MRI recipes
(``inference.load_model`` -> ``inference.ar_loop`` / ``ar_loop_batched`` /
``ar_loop_scan``, the last two through a captured CUDA graph on a card;
int8 and bf16 weight storage; ``bin/decode.py``) and the GAN training step (``bin/train.py`` -> ``train/trainer.py`` ->
``train/gan.py``) on an NVIDIA H100, with the generator's residual pairs
and the scale discriminator's first two layers in hand-written CUDA kernels
(``csrc/resblock_pair.cu``, ``csrc/scale_disc_head.cu``); a generator
exports through ``torch.export`` with the pair as a registered op
(``export.py``). Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; without a card they
raise. The package imports nothing of ``articulatory_tpu`` and no JAX.
"""

__version__ = "0.1.0"
