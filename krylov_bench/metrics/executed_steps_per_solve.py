"""``executed_steps_per_solve`` (layer: driver loop): steps run a traced
solve, masked ones past convergence included, counted from the program's
``its.step`` spans (one a step of ``run_chunked``), not from a kernel's
launches, so it keeps counting when a step's kernels change."""

from krylov_bench import spans


def read(run):
    s = spans.of(run)
    if s is None:
        return None
    return len(s.steps) / len(run.trace.solves)
