"""The hand pair backward's least time over its device time (its weight
splits, data and weight gradients and reduction) in the phase traced with
host ops: every pair of the generator differentiated once a step."""

from portbench import flops
from portbench.core.readers import roofline_pct
from portbench.kernels import resblock_pair_backward


def read(run):
    model = run.cell.model
    frames = model["batch_max_steps"] // model["hop_size"]
    return roofline_pct(run, resblock_pair_backward, flops.pair_calls(
        model["generator_params"], run.cell.precision,
        run.cell.traffic["batch"], frames))
