"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit)."""

TF32_FLOPS = 495e12      # TF32 tensor cores
BF16_FLOPS = 989e12      # bf16 / fp16 tensor cores
HBM_BYTES = 3.35e12      # HBM3 bytes a second
# the hand kernels' float32 path runs three TF32 products a multiply-add
# (3xTF32), so its operation bound is 3 x flops / TF32_FLOPS
TF32_PRODUCTS = 3

# the dense tensor-core peak a configuration's precision is held to
MODEL_PEAK = {"f32": TF32_FLOPS, "hybrid": BF16_FLOPS, "bf16": BF16_FLOPS}
