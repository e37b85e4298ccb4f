"""Set-up: process start to the window's start (imports, the CUDA context,
the kernels' load or build, Problem(deck), the warm-up request)."""


def read(run):
    return run.setup_s
