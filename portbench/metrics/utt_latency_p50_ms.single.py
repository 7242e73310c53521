"""Median utterance latency of the traced run's untraced phase, from the
call to the waveform on the host."""

from portbench.core.readers import latency_ms


def read(run):
    return latency_ms(run, 50, "host")
