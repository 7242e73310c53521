"""The inversion training step's model FLOPs (``flops_w2a.py``: the
Transformer's forward and backward) over the traced run's untraced phase,
as a share of the dense tensor-core peak of the cell's precision."""

from portbench import flops_w2a
from portbench.core import peaks


def read(run):
    phase = run.phase("host")
    if phase is None:
        return None
    step = flops_w2a.train_step_flops(run.cell.model,
                                      run.cell.traffic["batch"])
    return (100.0 * phase.counts["steps"] * step / phase.seconds
            / peaks.MODEL_PEAK[run.cell.precision])
