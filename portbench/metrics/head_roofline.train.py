"""The hand scale-discriminator head's least time over its device time
(the head and its weight split) in the phase traced with host ops."""

from portbench import flops
from portbench.core.readers import roofline_pct
from portbench.kernels import scale_disc_head


def read(run):
    model = run.cell.model
    dtype = ("bf16" if model["discriminator_params"].get("compute_dtype")
             == "bfloat16" else "f32")
    calls = [c + (dtype,) for c in flops.head_calls(
        model["discriminator_params"], run.cell.traffic["batch"],
        flops.disc_length(model))]
    return roofline_pct(run, scale_disc_head,
                        calls * flops.HEAD_FORWARDS_A_STEP)
