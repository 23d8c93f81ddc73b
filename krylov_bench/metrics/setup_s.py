"""``setup_s``: process start to the window's start (host clock): imports,
the CUDA context, the port's kernels, the operator and right-hand sides
from the seed, and one warm-up solve."""


def read(run):
    return run.setup_s
