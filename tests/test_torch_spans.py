"""The solve path's spans (``utils/profiling.span``): under a profiler,
``run_chunked`` marks each executed step (``its.step``) and each host read of
``done`` (``its.sync``), CG's step its preconditioner apply (``its.precond``)
and its product (``its.spmv``), and ``make_history`` the result's copy
(``its.history``).  With no profiler running a span is a shared no-op, and
the solve's results are the same bits either way."""

import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import iterativesolvers_tpu_torch as its
from iterativesolvers_tpu_torch.solvers.common import (CHUNK, _phases,
                                                       chunked_steps)
from iterativesolvers_tpu_torch.utils import fixtures, profiling

torch.set_num_threads(1)

N = 64
CHUNKS = (1, 8, CHUNK, 256)
PRECONDS = ("none", "diagonal")


def _problem(precond):
    A = fixtures.laplace_dia(N, 1, dtype=np.float64, device="cpu")
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(N))
    d = torch.full((N,), 2.0, dtype=torch.float64)
    Pl = (its.DiagonalPreconditioner(d, device="cpu")
          if precond == "diagonal" else None)
    return A, b, Pl


def _solve(precond, chunk):
    A, b, Pl = _problem(precond)
    return its.cg(A, b, Pl=Pl, reltol=1e-10, log=True, chunk=chunk)


def _host_reads(iters, chunk):
    """Host reads of ``done`` by ``run_chunked``: one before each step at
    ``chunk <= 1``; else one before the first phase and one after each phase
    run: the phases through the last live step and the one queued behind
    them before the read (of the phase before) that ends the solve."""
    if chunk <= 1:
        return iters + 1
    ran, phases = 0, 0
    for c in _phases(chunk):
        if ran >= iters:
            return 1 + phases + 1
        ran += c
        phases += 1


def _spans(tmp_path, precond, chunk):
    with profiling.trace(str(tmp_path)):
        x, h = _solve(precond, chunk)
    with open(os.path.join(tmp_path, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("its."):
            assert e["cat"] == "cpu_op", e
            ts = float(e["ts"])
            out.setdefault(e["name"], []).append((ts, ts + float(e["dur"])))
    return x, h, out


@pytest.mark.parametrize("precond", PRECONDS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_trace_holds_a_span_per_step_read_and_history(tmp_path, chunk,
                                                      precond):
    _, h, spans = _spans(tmp_path, precond, chunk)
    assert h.isconverged and h.iters > 8
    assert len(spans["its.step"]) == chunked_steps(h.iters, chunk)
    assert len(spans["its.sync"]) == _host_reads(h.iters, chunk)
    assert len(spans["its.history"]) == 1
    steps = sorted(spans["its.step"])
    for name in ("its.precond", "its.spmv"):
        assert len(spans[name]) == len(steps), name
        for a, b in spans[name]:
            assert any(s <= a and b <= e for s, e in steps), (name, a, b)
    # host reads and the result's copy lie outside every step
    for name in ("its.sync", "its.history"):
        for a, b in spans[name]:
            assert not any(s < b and a < e for s, e in steps), name


@pytest.mark.parametrize("precond", PRECONDS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_spans_change_no_bit_of_the_result(tmp_path, chunk, precond):
    x_on, h_on, _ = _spans(tmp_path, precond, chunk)
    x_off, h_off = _solve(precond, chunk)
    assert torch.equal(x_on, x_off)
    assert h_on.iters == h_off.iters and h_on.mvps == h_off.mvps
    assert np.array_equal(h_on["resnorm"], h_off["resnorm"])


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_without_a_profiler_a_span_is_one_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name!r} recorded with no profiler")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    assert profiling.span("its.step") is profiling.span("its.sync")
    with _CountOps() as mode:
        with profiling.span("its.step"):
            pass
    assert mode.ops == []
    for chunk in CHUNKS:
        x, h = _solve("diagonal", chunk)
        assert h.isconverged
    # the patched recorder is the one a span takes while a profiler runs
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=cpu):
        with pytest.raises(AssertionError, match="its.sync"):
            _solve("none", 8)
