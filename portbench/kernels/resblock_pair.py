"""The hand residual-pair kernel (``csrc/resblock_pair.cu``): its device
names and the least time one call can take."""

from portbench.core import peaks

# the pair, and the prep kernel that splits its f32 weights into tf32 halves
NAMES = ("resblock_pair_wgmma", "split_tf32_kernel")
CALL = "resblock_pair_wgmma"


def bound_s(b: int, t: int, c: int, k: int, dtype: str) -> float:
    """Least seconds for ``y = x + conv2(lrelu(conv1(lrelu(x))))`` over x
    (b, t, c), both kernels (k, c, c): operations (4 b t c^2 k; bf16 at the
    bf16 peak, f32 as three TF32 products) or bytes (x in, y out, both
    kernels and biases once), whichever is larger."""
    flops = 4.0 * b * t * c * c * k
    size = 2 if dtype == "bf16" else 4
    nbytes = (2.0 * b * t * c + 2.0 * k * c * c + 2.0 * c) * size
    ops_s = (flops / peaks.BF16_FLOPS if dtype == "bf16"
             else peaks.TF32_PRODUCTS * flops / peaks.TF32_FLOPS)
    return max(ops_s, nbytes / peaks.HBM_BYTES)
