"""``history_ms_per_solve`` (layer: result copy), ms: host milliseconds
inside the ``its.history`` span of each traced solve (``make_history``: the
scalar reads and the residual log's copy to the host), over the solves."""

from krylov_bench import spans


def read(run):
    s = spans.of(run)
    if s is None or not s.count(spans.HISTORY):
        return None
    return s.host_us(spans.HISTORY) * 1e-3 / len(run.trace.solves)
