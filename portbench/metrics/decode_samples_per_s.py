"""Real output samples (not the padding) completed in the window, over the
window's seconds by the host clock."""


def read(run):
    return run.counts["samples"] / run.seconds
