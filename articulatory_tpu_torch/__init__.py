"""articulatory_tpu_torch: the PyTorch/CUDA port of articulatory_tpu.

It carries the E2W HiFi-CAR decode path (``inference.load_model`` ->
``inference.ar_loop`` / ``ar_loop_batched``, ``bin/decode.py``) on an NVIDIA
H100, with its residual pairs in a hand-written CUDA kernel
(``csrc/resblock_pair.cu``). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without a card they raise. The package imports
nothing of ``articulatory_tpu`` and no JAX.
"""

__version__ = "0.1.0"
