"""The training step's model FLOPs (generator forward and backward,
regeneration, the discriminator's passes) over the traced run's untraced
phase, as a share of the dense tensor-core peak of the cell's precision."""

from portbench.core.readers import train_mfu_pct


def read(run):
    return train_mfu_pct(run)
