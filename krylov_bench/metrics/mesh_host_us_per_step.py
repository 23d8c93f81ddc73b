"""``mesh_host_us_per_step`` (layer: host dispatch on the mesh), us/step:
rank 0's host microseconds inside the program's ``its.step`` spans (a step
enqueued launch by launch) and ``its.replay`` spans (a phase of steps
replayed from a CUDA graph) of the traced solves, over the executed steps:
what the host spends to keep the cards fed.  Every collective of a step
waits for the slowest rank's host, so on the mesh this time paces the
cards where it passes their own.  Nothing on one card.

It is the traced reading: under the profiler's CUDA tracing the launch of
a graph costs the host about a microsecond and a half a node, a cost an
untraced run does not pay, and the span includes it.  A replay's host time
overlaps the cards' work but for the phase's first steps, so the metric
moves ``solve_ms`` only where it passes a phase's device time."""

from krylov_bench import spans

REPLAY = "its.replay"


def read(run):
    if run.trace is None or run.cell.chips < 2:
        return None
    # built here: spans.of gives nothing where no step span was recorded,
    # as in a solve whose phases are all replayed
    s = spans.Spans(run.trace)
    executed = run.executed_steps()
    if not (s.count(spans.STEP) or s.count(REPLAY)) or executed <= 0:
        return None
    return (s.host_us(spans.STEP) + s.host_us(REPLAY)) / executed
