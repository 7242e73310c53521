"""The window's milliseconds by the host clock over the training steps it
completed (each ends in a device synchronisation)."""


def read(run):
    return 1e3 * run.seconds / run.counts["steps"]
