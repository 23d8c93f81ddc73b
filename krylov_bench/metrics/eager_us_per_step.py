"""``eager_us_per_step`` (layer: eager step glue and preconditioner apply):
device microseconds a executed step in operations that the program's
``csrc/`` did not build (torch's elementwise kernels, reductions, copies and
fills, the red-black passes), inside the traced solves.  The kernels that
``csrc/`` builds are named in ``kernels/*.json``."""

from krylov_bench import tracefile


def read(run):
    if run.trace is None:
        return None
    executed = run.executed_steps()
    if executed <= 0:
        return None
    eager = sum(b - a for a, b, name in run.trace.solve_ops()
                if tracefile.family_of(name, run.families) is None)
    return eager / executed
