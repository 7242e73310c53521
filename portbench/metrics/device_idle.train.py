"""100 - the device's busy share at the untraced pace: the busy time a
step in the phase traced for device activity alone (the union of its
kernels' and copies' intervals) over the time a step takes in the
untraced phase. Tracing the eager step's device activity slows its host
launches by about 5 %, and not its device work."""

from portbench.core.readers import paced_idle_pct


def read(run):
    return paced_idle_pct(run, "steps")
