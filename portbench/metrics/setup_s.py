"""Set-up: process start to the window's start (imports, the kernels'
build or load, weights, inputs, warm-up and capture), by the host clock."""


def read(run):
    return run.setup_s
