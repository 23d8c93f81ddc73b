"""``precond_us_per_step`` (layer: preconditioner apply), us/step: device
microseconds of the operations launched inside CG's ``its.precond`` spans
(``Pl.ldiv``), over the executed steps."""

from krylov_bench import spans


def read(run):
    s = spans.of(run)
    if s is None or not s.count(spans.PRECOND):
        return None
    return s.per_step(s.device_us(spans.PRECOND))
