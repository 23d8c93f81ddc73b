"""``collective_us_per_step`` (layer: mesh collectives), us/step: device
microseconds of NCCL's kernels in rank 0's traced solves, over the executed
steps.  An NCCL kernel runs from its start until every rank has given its
share, so this is the communication that the step does not hide plus the
wait for the slowest rank, not the time on the wire alone."""

import re

NCCL = re.compile(r"\bnccl\w*Kernel")


def read(run):
    if run.trace is None:
        return None
    ops = [op for op in run.trace.solve_ops() if NCCL.search(op[2])]
    executed = run.executed_steps()
    if not ops or executed <= 0:
        return None
    return sum(b - a for a, b, _ in ops) / executed
