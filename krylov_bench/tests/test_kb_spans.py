"""The readers of the program's spans (``spans.py`` and the five metrics
that read it), on a small synthetic Chrome trace with ``its.*`` spans,
launch calls and their correlation ids."""

import json

import pytest

from krylov_bench import harness, spans, tracefile

STENCIL = "void stencil_kernel<float, float, true>(float const*, int const*)"
ADD = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::CUDAFunctor_add<float> >(int, float*)")
PRE = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::addcmul_kernel<float> >(int, float*)")
SPAN_METRICS = ("executed_steps_per_solve", "glue_us_per_step",
                "precond_us_per_step", "launches_per_step",
                "history_ms_per_solve")


def _metric(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py")


def X(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


class _Events:
    def __init__(self, with_spans):
        self.ev = []
        self.corr = 0
        self.with_spans = with_spans

    def span(self, name, ts, dur):
        if self.with_spans:
            self.ev.append(X("cpu_op", name, ts, dur))

    def launch(self, call, cat, name, ts, at, dur):
        """A launch call at ``ts`` and the device operation it makes."""
        self.corr += 1
        self.ev.append(X("cuda_runtime", call, ts, 1, self.corr))
        self.ev.append(X(cat, name, at, dur, self.corr))


def _trace(with_spans=True):
    """A calibration product, then two solves of four steps.  A solve: a
    5 us fill outside any span; a host read of ``done`` (``its.sync``, a
    1 us copy) before the steps and one (a 4 us copy) after them; each step
    (``its.step``) a 20 us preconditioner kernel inside ``its.precond``, a
    10 us stencil launch inside ``its.spmv`` and a 30 us add in the step's
    own glue; then ``its.history``, 400 us on the host around a 300 us
    copy and a 2 us one.  The first solve's fill has no launch record."""
    t = _Events(with_spans)
    t.ev.append(X("user_annotation", tracefile.CALIBRATE, 0, 100))
    t.launch("cudaLaunchKernel", "kernel", STENCIL, 5, 10, 10)
    for s0 in (200, 1300):
        t.ev.append(X("user_annotation", tracefile.SOLVE, s0, 1000))
        t.launch("cudaMemsetAsync", "gpu_memset", "Memset (Device)",
                 s0 + 1, s0 + 3, 5)
        if s0 == 200:
            t.ev.pop(-2)
        t.span(spans.SYNC, s0 + 5, 4)
        t.launch("cudaMemcpyAsync", "gpu_memcpy", "Memcpy DtoH",
                 s0 + 6, s0 + 8, 1)
        for k in range(4):
            a = s0 + 10 + 100 * k
            t.span(spans.STEP, a, 90)
            t.span(spans.PRECOND, a + 1, 9)
            t.launch("cudaLaunchKernel", "kernel", PRE, a + 2, a + 5, 20)
            t.span(spans.SPMV, a + 20, 10)
            t.launch("cuLaunchKernel", "kernel", STENCIL, a + 21, a + 30, 10)
            t.launch("cudaLaunchKernel", "kernel", ADD, a + 40, a + 45, 30)
        t.span(spans.SYNC, s0 + 420, 10)
        t.launch("cudaMemcpyAsync", "gpu_memcpy", "Memcpy DtoH",
                 s0 + 421, s0 + 425, 4)
        t.span(spans.HISTORY, s0 + 500, 400)
        t.launch("cudaMemcpyAsync", "gpu_memcpy", "Memcpy DtoH",
                 s0 + 510, s0 + 520, 300)
        t.launch("cudaMemcpyAsync", "gpu_memcpy", "Memcpy DtoH",
                 s0 + 880, s0 + 885, 2)
        t.ev.append(X("cuda_runtime", "cudaStreamSynchronize", s0 + 960, 30))
    return t.ev


def _run(events, iters=(3, 4)):
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell("pcg_rbic.poisson7_216", bench,
                        overrides={"rows": 1_000_000})
    run = harness.RunData(cell, "NVIDIA H100 80GB HBM3", None)
    run.trace = tracefile.Trace(events)
    run.iters = list(iters)
    return run


def test_each_device_operation_falls_in_one_set():
    s = spans.Spans(tracefile.Trace(_trace()))
    want = {spans.PRECOND: (8, 160), spans.SPMV: (8, 80), spans.STEP: (8, 240),
            spans.SYNC: (4, 10), spans.HISTORY: (4, 604),
            spans.OUTSIDE: (1, 5), spans.UNMATCHED: (1, 5)}
    assert {k: (len(v), s.device_us(k)) for k, v in s.ops.items()} == want
    assert s.ops[spans.UNMATCHED][0][0] == 203
    # no operation shifts to another's launch
    assert all(op[2] == PRE for op in s.ops[spans.PRECOND])
    assert all(op[2] == STENCIL for op in s.ops[spans.SPMV])
    assert s.launches_in_steps == 24
    assert spans.order_agrees(_trace()) == (33, 33)


def test_the_five_readers_against_the_hand_count():
    run = _run(_trace())
    got = {m: _metric(m).read(run) for m in SPAN_METRICS}
    assert got == pytest.approx({
        "executed_steps_per_solve": 4.0, "glue_us_per_step": 30.0,
        "precond_us_per_step": 20.0, "launches_per_step": 3.0,
        "history_ms_per_solve": 0.4})
    # the program's step count agrees with the stencil's, and the seven
    # sets hold every operation that the outside reader counts
    assert run.executed_steps() == 8
    s = spans.of(run)
    eager = sum(s.device_us(k) for k in s.ops if k != spans.SPMV)
    assert _metric("eager_us_per_step").read(run) * 8 == pytest.approx(eager)


def test_idle_time_by_span():
    s = spans.Spans(tracefile.Trace(_trace()))
    # the shortest launch latency, 2 us, read as the clocks' offset
    assert s.clock_offsets() == [2, 2]
    idle = s.idle_by_span()
    # each solve: 1000 us, 552 us of it busy
    assert sum(idle.values()) == pytest.approx(2 * 448e-6)
    # the host in its.history between its two copies: 65 us a solve
    assert idle[spans.HISTORY] == pytest.approx(130e-6)


def test_the_device_clock_running_ahead_moves_no_match():
    """In some sessions the trace puts the device's operations milliseconds
    off the host's clock: the matching compares no time across them, and
    the idle time is taken on the host's clock."""
    ev = _trace()
    for e in ev:
        if e["cat"] in tracefile.DEVICE_CATS:
            e["ts"] += 3000
    s = spans.Spans(tracefile.Trace(ev))
    assert [len(s.ops[k]) for k in (spans.PRECOND, spans.SPMV, spans.STEP)] \
        == [8, 8, 8]
    assert spans.order_agrees(ev) == (33, 33)
    assert s.clock_offsets() == [3002, 3002]
    assert s.idle_by_span()[spans.HISTORY] == pytest.approx(130e-6)


def test_idle_time_stays_inside_each_solve_when_the_clocks_drift():
    """The device's clock drifting 200 us within a solve puts its last
    operations past the solve's end once moved by the solve's least offset;
    they are cut at the end, and no stretch reads negative."""
    ev = _trace()
    for e in ev:
        if e["cat"] in tracefile.DEVICE_CATS and e["ts"] > 700:
            e["ts"] += 200
    idle = spans.Spans(tracefile.Trace(ev)).idle_by_span()
    assert min(idle.values()) >= 0
    # the first solve's busy time: 250 us before the big copy, which is cut
    # from 918-1218 to 918-1200 us, and the small copy falls past the end
    assert sum(idle.values()) == pytest.approx((1000 - 532 + 448) * 1e-6)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_each_reader_finds_nothing_without_spans(name):
    run = _run(_trace(with_spans=False))
    assert run.executed_steps() == 8
    assert _metric(name).read(run) is None
    run.trace = None
    assert _metric(name).read(run) is None


def test_a_record_lost_at_the_sessions_start_shifts_no_match():
    """CUPTI at times loses a session's first records: the launch is left
    over and every operation of the solves still meets its own launch."""
    ev = [e for e in _trace() if not (e["cat"] == "kernel" and e["ts"] == 10)]
    s = spans.Spans(tracefile.Trace(ev))
    assert sum(len(v) for v in s.ops.values()) == 34
    assert all(op[2] == PRE for op in s.ops[spans.PRECOND])
    assert spans.order_agrees(ev) == (33, 33)


def test_a_record_lost_inside_a_solve_shows_in_the_agreement():
    """Order alone cannot tell where inside the session a record went
    missing: the operations before it shift, and ``order_agrees`` counts
    them."""
    ev = [e for e in _trace()
          if not (e["cat"] == "kernel" and e["ts"] == 1540)]  # a STENCIL
    agree, total = spans.order_agrees(ev)
    assert total == 32 and agree < total
