"""The banded relative-position attention's kernels
(``articulatory_tpu_torch/csrc/banded_attention.cu``): their device names
and the least time one layer's attention, forward and backward, can take.
"""

from portbench.core import peaks
from portbench.flops_w2a import band_pairs

# the forward and the backward kernels
NAMES = ("banded_attn_",)
# launched once in every forward
CALL = "banded_attn_fwd_kernel"


def bound_s(b: int, h: int, length: int, d: int, m: int) -> float:
    """Least seconds for the forward and backward of banded attention over
    q, k, v (b, h, length, d) with a table (h, 2m - 1, d) and a uint8 keep
    mask: operations (q k^T, P V and q E over the in-band keys, 6 per pair
    and d forward, their gradients 12 backward, as three TF32 products) or
    bytes (q, k, v, o in and their gradients out, the table and its
    gradient, the mask, once each, in float32), whichever is larger."""
    flops = 18.0 * b * h * band_pairs(length, m) * d
    nbytes = (8.0 * b * h * length * d * 4 + 2.0 * h * (2 * m - 1) * d * 4
              + b * h * length * (2 * m - 1))
    return max(peaks.TF32_PRODUCTS * flops / peaks.TF32_FLOPS,
               nbytes / peaks.HBM_BYTES)
