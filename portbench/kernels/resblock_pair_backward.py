"""The hand residual pair's backward (``csrc/resblock_pair_backward.cu``):
its device names and the least time one pair's gradients can take."""

from portbench.core import peaks

# the weight splits, the data gradient (h and dh, then dx), the weight
# gradient and the reduction of its partial sums
NAMES = ("pair_bwd_split_kernel", "pair_bwd_hidden_kernel",
         "pair_bwd_input_kernel", "pair_bwd_weight_kernel",
         "pair_bwd_reduce_kernel")
# launched once in every backward of a pair
CALL = "pair_bwd_hidden_kernel"


def bound_s(b: int, t: int, c: int, k: int, dtype: str) -> float:
    """Least seconds for the gradients of ``y = x + conv2(lrelu(conv1(
    lrelu(x))))`` over x (b, t, c), both kernels (k, c, c): operations (the
    two data and two weight gradient convolutions, 8 b t c^2 k; bf16 at the
    bf16 peak, f32 as three TF32 products) or bytes (x and gy in, dx out,
    both kernels in and their gradients and the biases' out, once each),
    whichever is larger. Recomputing h is the design's own cost and is not
    counted."""
    flops = 8.0 * b * t * c * c * k
    size = 2 if dtype == "bf16" else 4
    nbytes = (3.0 * b * t * c + 4.0 * k * c * c + 2.0 * c) * size
    ops_s = (flops / peaks.BF16_FLOPS if dtype == "bf16"
             else peaks.TF32_PRODUCTS * flops / peaks.TF32_FLOPS)
    return max(ops_s, nbytes / peaks.HBM_BYTES)
