"""The hand scale-discriminator head (``csrc/scale_disc_head.cu``): layers
0 and 1 of a scale discriminator in one kernel; its device names and the
least time one call can take."""

from portbench.core import peaks

NAMES = ("scale_disc_head_wgmma", "split_weights_kernel")
CALL = "scale_disc_head_wgmma"


def bound_s(b: int, t: int, ch: int, k0: int, k1: int, groups: int,
            stride: int, dtype: str) -> float:
    """Least seconds for conv0 (1 -> ch, kernel k0) and the grouped, strided
    conv1 (ch -> ch, kernel k1) over x (b, t, 1): operations (bf16 at the
    bf16 peak, f32 as three TF32 products) or bytes (x in, h0 and h1 out,
    weights and biases once), whichever is larger."""
    t1 = (t - 1) // stride + 1
    flops = 2.0 * b * t * ch * k0 + 2.0 * b * t1 * ch * (ch // groups) * k1
    size = 2 if dtype == "bf16" else 4
    nbytes = (b * t + b * t * ch + b * t1 * ch + k0 * ch
              + k1 * (ch // groups) * ch + 2 * ch) * size
    ops_s = (flops / peaks.BF16_FLOPS if dtype == "bf16"
             else peaks.TF32_PRODUCTS * flops / peaks.TF32_FLOPS)
    return max(ops_s, nbytes / peaks.HBM_BYTES)
