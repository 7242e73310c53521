"""Model FLOPs of each utterance's own chunks over the traced run's
untraced phase, as a share of the dense tensor-core peak of the cell's
precision."""

from portbench.core.readers import decode_mfu_pct


def read(run):
    return decode_mfu_pct(run)
