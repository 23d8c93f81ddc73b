"""``glue_us_per_step`` (layer: eager step glue), us/step: device
microseconds of the operations launched inside an ``its.step`` span and
outside its nested ``its.precond`` and ``its.spmv`` (the step's vector
updates, dots, masks and the residual log's write), over the executed
steps."""

from krylov_bench import spans


def read(run):
    s = spans.of(run)
    if s is None:
        return None
    return s.per_step(s.device_us(spans.STEP))
