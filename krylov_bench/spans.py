"""The program's spans in a traced run, and each device operation placed in
the span that launched it.

Under a profiler the port marks its solve path with host ranges named
``its.*`` (``iterativesolvers_tpu_torch/utils/profiling.span``): ``its.step``
around each executed step, ``its.sync`` around each host read of ``done``,
``its.precond`` and ``its.spmv`` inside CG's step, ``its.history`` around
the copy of the result to the host.  They are ``cpu_op`` events of the
Chrome trace, so ``tracefile.Trace`` keeps them among its host operations,
on the clock of the device's operations.

``Trace`` keeps the name and times of each host call and device operation,
not the correlation id that ties an operation to the call that launched it.
So operations are matched to launches in order: on one stream the device
runs operations in the order the host launched them, and each launch call
makes one operation of its kind (a kernel, a copy, a fill).  The matching
compares no time across the two clocks: in some sessions the device's
clock, as the trace gives it, runs milliseconds ahead of the host's or
behind it.  It runs from the trace's end backwards, since CUPTI at times
loses the records of a session's first operations: the launches left over
are then the session's first, and no match after them shifts.  An operation
left over has no launch record and is counted apart, never dropped.

A traced solve's operations are those launched inside its ``kb.solve``
block, by the host's clock, and those with no launch record that start
inside it.  A launch is placed in the innermost ``its.*`` span open when it
started.
"""

from __future__ import annotations

import bisect

from krylov_bench import tracefile

PREFIX = "its."
STEP = "its.step"
SYNC = "its.sync"
PRECOND = "its.precond"
SPMV = "its.spmv"
HISTORY = "its.history"
OUTSIDE = "(outside any span)"
UNMATCHED = "(no launch record)"


def launch_kind(name: str):
    """The kind of device operation a runtime or driver call makes, or None
    for a call that makes none (a synchronisation, an allocation, ...)."""
    if not name.startswith("cu"):
        return None
    if "LaunchKernel" in name or "LaunchCooperativeKernel" in name:
        return "kernel"
    if "Memcpy" in name:
        return "memcpy"
    if "Memset" in name:
        return "memset"
    return None


def op_kind(name: str) -> str:
    """The kind of a device operation, from its name in the trace."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def match_launches(host, device):
    """For each of ``device`` (sorted by start), the start of the host call
    that launched it, or None where the launches of its kind ran out (see
    the module's docstring)."""
    launches, ops = {}, {}
    for ts, _, name in host:
        kind = launch_kind(name)
        if kind is not None:
            launches.setdefault(kind, []).append(ts)
    for j, (_, _, name) in enumerate(device):
        ops.setdefault(op_kind(name), []).append(j)
    out = [None] * len(device)
    for kind, js in ops.items():
        for j, ts in zip(reversed(js), reversed(launches.get(kind, ()))):
            out[j] = ts
    return out


def innermost(spans, times):
    """For each of ``times``, the name of the innermost of ``spans``
    (``(start, end, name)``, nested as a call stack nests) open at that
    time, or None."""
    order = sorted(range(len(times)), key=times.__getitem__)
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out = [None] * len(times)
    stack, i = [], 0
    for k in order:
        t = times[k]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[k] = stack[-1][2]
    return out


def _block(intervals, t):
    """The index of the one of ``intervals`` (sorted, disjoint) that holds
    ``t``, or None."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i if i >= 0 and t < intervals[i][1] else None


def _inside(intervals, t) -> bool:
    return _block(intervals, t) is not None


class Spans:
    """The ``its.*`` spans of a trace's solves, and the solves' device
    operations sorted by the span that launched each."""

    def __init__(self, trace):
        self.trace = trace
        solves = trace.solves
        self.spans = [h for h in trace.host
                      if h[2].startswith(PREFIX) and _inside(solves, h[0])]
        self.steps = sorted((a, b) for a, b, n in self.spans if n == STEP)
        # (operation, its launch's start or None) of each traced solve
        self.solve_ops = [[] for _ in solves]
        for op, t in zip(trace.device,
                         match_launches(trace.host, trace.device)):
            i = _block(solves, op[0] if t is None else t)
            if i is not None:
                self.solve_ops[i].append((op, t))
        ops = [pair for solve in self.solve_ops for pair in solve]
        placed = innermost(self.spans, [-1.0 if t is None else t
                                        for _, t in ops])
        self.ops = {}                   # set name -> [(start, end, name)]
        for (op, t), name in zip(ops, placed):
            key = UNMATCHED if t is None else name or OUTSIDE
            self.ops.setdefault(key, []).append(op)
        self.launches_in_steps = sum(
            1 for ts, _, name in trace.host
            if launch_kind(name) and _inside(self.steps, ts))

    def count(self, name: str) -> int:
        return sum(1 for s in self.spans if s[2] == name)

    def host_us(self, name: str) -> float:
        return sum(b - a for a, b, n in self.spans if n == name)

    def device_us(self, key: str) -> float:
        """Device microseconds of the operations of one set (a span's name,
        ``OUTSIDE`` or ``UNMATCHED``)."""
        return sum(b - a for a, b, _ in self.ops.get(key, ()))

    def per_step(self, value: float):
        """``value`` over the executed steps, or None with no step span."""
        return value / len(self.steps) if self.steps else None

    def clock_offsets(self) -> list:
        """Of each traced solve, the least lead of an operation's start over
        its launch's, in microseconds: how far the device's clock runs ahead
        of the host's in the trace, with the shortest launch latency (a few
        microseconds) added."""
        return [min((op[0] - t for op, t in solve if t is not None),
                    default=0.0) for solve in self.solve_ops]

    def idle_by_span(self) -> dict:
        """The seconds of the solves' idle stretches by the innermost span
        the host was in at each stretch's midpoint.  Each solve's operations
        are moved onto the host's clock by its :meth:`clock_offsets`."""
        out = {}
        for (lo, hi), solve, off in zip(self.trace.solves, self.solve_ops,
                                         self.clock_offsets()):
            # the offset is the solve's least; where the clocks drift within
            # a solve, an operation can land past its edges: it is cut there
            moved = ((max(op[0] - off, lo), min(op[1] - off, hi))
                     for op, _ in solve)
            busy = tracefile.merged((a, b) for a, b in moved if a < b)
            gaps, t = [], lo
            for a, b in busy:
                if a > t:
                    gaps.append((t, a))
                t = max(t, b)
            if hi > t:
                gaps.append((t, hi))
            names = innermost(self.spans, [(a + b) / 2 for a, b in gaps])
            for (a, b), name in zip(gaps, names):
                key = name or OUTSIDE
                out[key] = out.get(key, 0.0) + (b - a) * 1e-6
        return out


def of(run):
    """The spans of ``run``'s trace, or None where it holds none (no trace,
    or a program that records no span)."""
    if run.trace is None:
        return None
    spans = Spans(run.trace)
    return spans if spans.steps else None



def order_agrees(events):
    """``(agree, total)``: of the device operations among raw Chrome trace
    ``events`` that a traced solve launched by their ``correlation`` id, how
    many :func:`match_launches` gives that launch, matching by order alone."""
    trace = tracefile.Trace(events)
    launch_at = {}
    by_op = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("ph") != "X" or corr is None:
            continue
        ts = float(e["ts"])
        if e.get("cat") in tracefile.DEVICE_CATS:
            by_op[(ts, ts + float(e.get("dur", 0.0)), e.get("name"))] = corr
        elif e.get("cat") in tracefile.HOST_CATS and launch_kind(e["name"]):
            launch_at[corr] = ts
    agree = total = 0
    for op, t in zip(trace.device, match_launches(trace.host, trace.device)):
        want = launch_at.get(by_op.get(op))
        if want is not None and _inside(trace.solves, want):
            total += 1
            agree += t == want
    return agree, total
