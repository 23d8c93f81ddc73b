"""Profiling and roofline accounting (port of
``iterativesolvers_tpu/utils/profiling.py``).

``trace(log_dir)`` records a ``torch.profiler`` trace (the host's ops and,
on a CUDA machine, the card's kernels) and writes it as a Chrome trace into
``log_dir``.  ``span(name)`` marks a stretch of the solve path (``its.step``,
``its.sync``, ``its.precond``, ``its.spmv``, ``its.history``) as a host
range of that trace, on the profiler's clock, while a profiler runs.
``measure_bandwidth`` times the JAX package's differential triad loop (CUDA
events on a card), ``roofline_report`` does the same bytes-per-iteration
arithmetic.  ``collective_counts`` counts the collectives a mesh
(``parallel/sharded.py``) issues over a window, under the keys of the JAX
function, which counts them in optimized HLO text.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

from .dtypes import as_dtype

__all__ = ["trace", "span", "measure_bandwidth", "roofline_report",
           "RooflineReport", "collective_counts"]

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span("its.step"): ...`` records the block as a host range
    named ``name`` while a ``torch.profiler`` session runs (``trace``, or
    any other): a ``cpu_op`` event of the Chrome trace, on the clock of the
    device's events, so each device operation can be placed in the span
    that launched it.  With no profiler running it costs one bool check and
    returns a shared no-op context: no allocation, no dispatcher call, no
    tensor op, no host read."""
    if _profiler_enabled():
        return _RecordFunctionFast(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('prof'): solver(...)`` writes
    ``log_dir/trace.json`` (Chrome trace format), with the solve path's
    ``its.*`` spans (:func:`span`); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def measure_bandwidth(n: int = 1 << 21, dtype=torch.float32, reps: int = 3,
                      device="cuda") -> float:
    """Empirical streaming bandwidth (bytes/s) of ``device`` from a
    differential triad loop, ``v <- 0.999 v + c`` (read v and c, write v):
    the time of 400 passes less that of 100, over 300 (cancels dispatch
    latency).  On a CUDA device each loop is timed with CUDA events."""
    dtype = as_dtype(dtype)
    dev = torch.device(device)
    c = torch.full((n,), 0.5, dtype=dtype, device=dev)
    cuda = dev.type == "cuda"

    def loop(k):
        v = torch.ones((n,), dtype=dtype, device=dev)
        for _ in range(k):
            torch.add(c, v, alpha=0.999, out=v)
        return v

    def timed(k):
        loop(k)                                   # warm-up
        if cuda:
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                loop(k)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            loop(k)
        return (time.perf_counter() - t0) / reps

    per_op = (timed(400) - timed(100)) / 300
    return 3 * c.element_size() * n / per_op


@dataclass
class RooflineReport:
    bytes_per_iter: int
    measured_iter_s: float
    bandwidth_bps: float

    @property
    def roofline_iter_s(self) -> float:
        return self.bytes_per_iter / self.bandwidth_bps

    @property
    def fraction(self) -> float:
        return self.roofline_iter_s / self.measured_iter_s

    def __repr__(self):
        return (
            f"RooflineReport({self.bytes_per_iter / 1e6:.1f} MB/iter, "
            f"{self.measured_iter_s * 1e6:.1f} us/iter measured vs "
            f"{self.roofline_iter_s * 1e6:.1f} us roofline -> "
            f"{self.fraction:.1%} of speed-of-light)"
        )


def roofline_report(
    bytes_per_iter: int,
    measured_iter_s: float,
    bandwidth_bps: Optional[float] = None,
) -> RooflineReport:
    """Fraction-of-roofline accounting for a solver iteration
    (``bandwidth_bps`` None: :func:`measure_bandwidth` on the card)."""
    if bandwidth_bps is None:
        bandwidth_bps = measure_bandwidth()
    return RooflineReport(int(bytes_per_iter), float(measured_iter_s),
                          float(bandwidth_bps))


# the JAX function's keys, each from the mesh's counts of some kinds: a halo
# exchange is two collective-permutes (one a direction), a ranged fetch of a
# sharded DIA product one (its sends and receives in one batch)
_KEYS = {"collective-permute": (("exchange", 2), ("fetch", 1)),
         "all-reduce": (("all_reduce", 1),),
         "all-gather": (("all_gather", 1),),
         "reduce-scatter": (("reduce_scatter", 1),), "all-to-all": ()}


@contextlib.contextmanager
def collective_counts(mesh):
    """The collectives ``mesh`` issues inside the ``with`` block, under the
    JAX function's keys (``collective-permute``, ``all-reduce``,
    ``all-gather``, ``reduce-scatter``, ``all-to-all``): yields a dict that
    is filled when the block ends.  The JAX package reads them from
    compiled HLO; here the mesh counts each call as it issues it
    (``RowMesh.counts``), so a count is of one run, not of a program."""
    before = dict(mesh.counts)
    out = {}
    try:
        yield out
    finally:
        for key, kinds in _KEYS.items():
            out[key] = sum(per * (mesh.counts[kind] - before[kind])
                           for kind, per in kinds)
