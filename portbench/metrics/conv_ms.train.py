"""Device ms a step of the kernels launched by host ops whose name holds
"conv" (cuDNN's convolutions, forward and backward, the pairs' recompute
among them), in the phase traced with host ops."""


def read(run):
    phase = run.phase("ops")
    if phase is None:
        return None
    seconds = phase.trace.launched_by_s("conv")
    return 1e3 * seconds / phase.counts["steps"] if seconds else None
