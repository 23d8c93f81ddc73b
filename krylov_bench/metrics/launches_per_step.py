"""``launches_per_step`` (layer: host dispatch), launches/step: the host's
launch calls (kernels, copies, fills) made inside the ``its.step`` spans,
the nested preconditioner and product included, over the executed steps.
Each is one trip through the CUDA runtime or driver that a host-paced step
waits on."""

from krylov_bench import spans


def read(run):
    s = spans.of(run)
    if s is None:
        return None
    return s.per_step(s.launches_in_steps)
