"""Seconds from process start to the window's first due time: imports,
CUDA, the kernels' build or load, the weights, the Server, the warm-up."""


def read(run):
    return run.setup_s
