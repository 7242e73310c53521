"""100 - the device's busy share of the phase traced for device activity
alone (the union of its kernels' and copies' intervals)."""

from portbench.core.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
