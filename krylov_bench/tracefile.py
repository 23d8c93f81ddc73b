"""The device trace: taken with ``torch.profiler``, read from its Chrome trace.

The harness marks each traced solve with ``record_function("kb.solve")``
and one product of the cell's operator, ahead of the solves, with
``"kb.calibrate"``; each block ends in a synchronisation, so its device work
starts and ends inside it.  Everything here reads the exported Chrome trace
(``prof.events()`` walks every event in Python, which takes minutes on a
solve of thousands of steps).  Times are in microseconds, as in the trace.
"""

from __future__ import annotations

import bisect
import json
import os
import pathlib
import re
import sys
import tempfile
import time

SOLVE = "kb.solve"
CALIBRATE = "kb.calibrate"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
# CUPTI at times hands back a whole session with no device activity; such a
# trace is taken again, up to this many times in all
TRIES = 3
KERNELS = pathlib.Path(__file__).resolve().parent / "kernels"


def load_families(directory=KERNELS) -> dict:
    """``{family: [compiled pattern, ...]}`` from ``kernels/<family>.json``:
    the names of the kernels that the program's ``csrc/`` builds."""
    out = {}
    for path in sorted(pathlib.Path(directory).glob("*.json")):
        spec = json.loads(path.read_text())
        out[path.stem] = [re.compile(r"\b%s\b" % re.escape(p))
                          for p in spec["patterns"]]
    return out


def family_of(name: str, families: dict):
    """The family whose pattern ``name`` matches, or None (a kernel that the
    program's ``csrc/`` did not build: torch's own, a library's, a copy)."""
    for fam, patterns in families.items():
        if any(p.search(name) for p in patterns):
            return fam
    return None


def short_name(name: str, width: int = 160) -> str:
    """A kernel's name without its return type and arguments: cut at the
    first ``(`` outside its template arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i].rstrip()[:width]
    return name[:width]


def merged(intervals):
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Trace:
    """The events of one profiler session that the readers need."""

    def __init__(self, events):
        device, host, marks = [], [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            ts = float(e["ts"])
            end = ts + float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                device.append((ts, end, e.get("name", cat)))
            elif cat == "user_annotation" and e.get("name") in (SOLVE,
                                                                 CALIBRATE):
                marks.append((e["name"], ts, end))
            elif cat in HOST_CATS:
                host.append((ts, end, e.get("name", cat)))
        device.sort()
        host.sort()
        self.device = device
        self.host = host
        self._host_starts = [h[0] for h in host]
        self.solves = sorted((a, b) for n, a, b in marks if n == SOLVE)
        cal = sorted((a, b) for n, a, b in marks if n == CALIBRATE)
        self.calibration = cal[0] if cal else None

    def window(self):
        """(start, end) of the traced solves: the first's start to the last's
        end."""
        return self.solves[0][0], self.solves[-1][1]

    def ops_in(self, intervals):
        """Device operations that start inside one of ``intervals``."""
        starts = [a for a, _ in intervals]
        out = []
        for op in self.device:
            i = bisect.bisect_right(starts, op[0]) - 1
            if i >= 0 and op[0] < intervals[i][1]:
                out.append(op)
        return out

    def solve_ops(self):
        return self.ops_in(self.solves)

    def calibration_ops(self):
        return self.ops_in([self.calibration]) if self.calibration else []

    def gaps(self):
        """The window's ``(start, end)`` stretches with no device operation."""
        lo, hi = self.window()
        out, t = [], lo
        for a, b in merged((a, b) for a, b, _ in self.device):
            if b <= lo or a >= hi:
                continue
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if hi > t:
            out.append((t, hi))
        return out

    def host_at(self, t: float, reach: int = 4096) -> str:
        """The innermost host operation running at ``t``: of those that
        cover it, the one that started last."""
        i = bisect.bisect_right(self._host_starts, t) - 1
        for j in range(i, max(i - reach, -1), -1):
            if self.host[j][1] >= t:
                return self.host[j][2]
        return "(no host op)"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time in the window, and the
        longest idle stretches summed by the host operation running in
        them; seconds."""
        ops = {}
        for a, b, name in self.ops_in([self.window()]):
            key = short_name(name)
            ops[key] = ops.get(key, 0.0) + (b - a) * 1e-6
        idle = {}
        for a, b in self.gaps():
            key = short_name(self.host_at((a + b) / 2))
            idle[key] = idle.get(key, 0.0) + (b - a) * 1e-6
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": [list(kv) for kv in order(ops)],
                "idle_gaps": [list(kv) for kv in order(idle)]}


def device_intervals(events):
    """``(start, end)`` of each device operation among Chrome trace events."""
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def profiled(body, cpu: bool, agree=None):
    """Run ``body()`` under ``torch.profiler`` (CUDA activity, and with
    ``cpu`` the host's operations too) until the session holds device
    activity, at most ``TRIES`` times; returns (the Chrome trace's events,
    what ``body`` returned).  The trace goes to a temporary directory under
    ``TMPDIR`` and is deleted once read.  On several ranks, ``agree(held)``
    says whether every rank's session held device activity, so that all
    take it again or none."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    for attempt in range(TRIES):
        with profile(activities=activities) as prof:
            out = body()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                data = json.load(fh)
        events = data["traceEvents"] if isinstance(data, dict) else data
        held = bool(device_intervals(events))
        if agree is not None:
            held = agree(held)
        if held:
            return events, out
        print(f"the trace holds no device time (try {attempt + 1} of "
              f"{TRIES}): taken again", file=sys.stderr, flush=True)
    raise RuntimeError(f"no device time in the trace in {TRIES} tries")


def device_window(solves, sync, agree=None):
    """Run each of ``solves``, each ended by ``sync()``, under the profiler
    with CUDA activity alone: the host's operations go unrecorded, which
    slows a solve whose host sets the pace less than recording them does.
    Returns (busy, window, the solves' results): the microseconds in which
    some device operation ran, and the microseconds from the first solve's
    start to the last's synchronised end by the host's clock.  The session
    starts and ends with the device idle, so its device operations are the
    solves'."""

    def body():
        sync()
        t0 = time.perf_counter()
        results = []
        for fn in solves:
            results.append(fn())
            sync()
        return results, time.perf_counter() - t0

    events, (results, seconds) = profiled(body, cpu=False, agree=agree)
    busy = sum(b - a for a, b in merged(device_intervals(events)))
    return busy, seconds * 1e6, results


def capture(calibrate, solves, sync, agree=None):
    """Run ``calibrate()`` then each of ``solves`` under ``torch.profiler``
    (the host's operations and CUDA activity), each in its marked block;
    returns (Trace, the solves' results).  ``agree`` as in
    :func:`profiled`."""
    from torch.profiler import record_function

    def body():
        with record_function(CALIBRATE):
            calibrate()
            sync()
        results = []
        for fn in solves:
            with record_function(SOLVE):
                results.append(fn())
                sync()
        return results

    events, results = profiled(body, cpu=True, agree=agree)
    trace = Trace(events)
    if not (trace.solves and trace.solve_ops()):
        raise RuntimeError("the trace marks no device operation in the solves")
    return trace, results
