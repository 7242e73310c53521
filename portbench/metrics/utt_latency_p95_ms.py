"""95th percentile of every utterance's latency in the window, from the
call to its waveform on the host."""

from portbench.core.readers import latency_ms


def read(run):
    return latency_ms(run, 95)
