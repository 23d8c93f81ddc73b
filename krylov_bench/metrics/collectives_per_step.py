"""``collectives_per_step`` (layer: mesh collectives), collectives/step:
NCCL's kernels in rank 0's traced solves, over the executed steps.  A CG
step on the mesh should run four: the halo exchange (its sends and
receives in one kernel) and the allreduces of its three dots."""

import re

NCCL = re.compile(r"\bnccl\w*Kernel")


def read(run):
    if run.trace is None:
        return None
    count = sum(1 for op in run.trace.solve_ops() if NCCL.search(op[2]))
    executed = run.executed_steps()
    if not count or executed <= 0:
        return None
    return count / executed
