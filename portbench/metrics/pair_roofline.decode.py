"""The hand pair's least time over its device time (the pair and its
weight split) in the phase traced with host ops."""

from portbench.core.readers import decode_pair_calls, roofline_pct
from portbench.kernels import resblock_pair


def read(run):
    return roofline_pct(run, resblock_pair, decode_pair_calls(run))
