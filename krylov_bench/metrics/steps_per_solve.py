"""``steps_per_solve`` (layer: solvers): live Krylov steps a traced solve,
from the ``ConvergenceHistory`` that the public ``log=True`` returns."""

import statistics


def read(run):
    if run.trace is None or not run.iters:
        return None
    return statistics.fmean(run.iters)
