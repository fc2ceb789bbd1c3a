"""The process's start to the window's start: imports, the CUDA context,
the weights, staging, the kernels' build or load, and the warm-up."""


def read(rule, record):
    return record.setup_s
