"""``useful_step_share`` (layer: driver loop), %: live steps over executed
steps in the traced solves.  Executed steps are the launches of the step's
kernel (the cell's SpMV kernel) over its launches in one traced product
``A.mv(x)``: masked steps past convergence run the kernel too."""


def read(run):
    if run.trace is None:
        return None
    executed = run.executed_steps()
    if executed <= 0:
        return None
    return 100.0 * sum(run.iters) / executed
