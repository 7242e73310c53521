"""The banded attention's least time (``kernels/banded_attention.py``:
each layer's forward and backward) over the device time of its kernels in
the phase traced with host ops."""

from portbench.core.readers import roofline_pct
from portbench.kernels import banded_attention
from portbench.reference.transformer import DISTANCE, HEADS


def read(run):
    model = run.cell.model
    gp = model["generator_params"]
    call = (run.cell.traffic["batch"], HEADS, model["batch_max_steps"],
            gp["hidden_dim"] // HEADS, DISTANCE)
    return roofline_pct(run, banded_attention, [call] * gp["elayers"])
