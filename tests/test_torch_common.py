"""The port's shared modules (``utils/dtypes.py``, ``utils/history.py``,
``solvers/common.py``) against the JAX package's, and the port's guards: it
imports no JAX, and its entry points run on the card unless asked.
"""

import ast
import pathlib
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativesolvers_tpu.solvers import common as jcommon
from iterativesolvers_tpu.utils import dtypes as jdtypes
from iterativesolvers_tpu.utils.history import ConvergenceHistory as JHistory

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.solvers import common as pcommon
from iterativesolvers_tpu_torch.utils import dtypes as pdtypes
from iterativesolvers_tpu_torch.utils.history import ConvergenceHistory

from _torch_port import to_torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _name(dt):
    return str(dt).removeprefix("torch.")


PAIRS = [("float32", "float32"), ("int8", "float32"), ("bfloat16", "float32"),
         ("float32", "float64"), ("float64", "float32"),
         ("complex64", "float32"), ("float64", "complex64"),
         ("complex128", "float64")]


@pytest.mark.parametrize("a,b", PAIRS)
def test_solve_dtype_matches_jax(a, b):
    want = jdtypes.solve_dtype(getattr(jnp, a), getattr(jnp, b))
    got = pdtypes.solve_dtype(getattr(torch, a), getattr(torch, b))
    assert _name(got) == np.dtype(want).name
    assert pdtypes.solve_dtype(np.dtype(a) if a != "bfloat16" else a,
                               np.dtype(b)) == got


@pytest.mark.parametrize("dt", ["float32", "float64", "complex64",
                                "complex128"])
def test_real_dtype_reltol_eps_zerox_match_jax(dt):
    assert _name(pdtypes.real_dtype(getattr(torch, dt))) == np.dtype(
        jdtypes.real_dtype(np.dtype(dt))).name
    assert pdtypes.default_reltol(dt) == jdtypes.default_reltol(np.dtype(dt))
    assert pdtypes.eps(dt) == jdtypes.eps(np.dtype(dt))
    A = pits.MatrixOperator(torch.eye(3, dtype=getattr(torch, dt)))
    z = pdtypes.zerox(A, torch.ones(3, dtype=torch.float32))
    assert z.dtype == torch.promote_types(getattr(torch, dt), torch.float32)
    assert not z.any()


def test_norm_vdot_tolerance_resolve_tols_match_jax(rng):
    a = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    b = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    np.testing.assert_allclose(float(pcommon.norm(to_torch(a))),
                               float(jcommon.norm(jnp.asarray(a))), rtol=1e-14)
    np.testing.assert_allclose(complex(pcommon.vdot(to_torch(a), to_torch(b))),
                               complex(jcommon.vdot(jnp.asarray(a),
                                                    jnp.asarray(b))),
                               rtol=1e-14)
    for reltol, abstol in ((None, None), (1e-3, None), (0.0, 1e-9)):
        for dt in ("float32", "complex128"):
            pr, pa = pcommon.resolve_tols(getattr(torch, dt), reltol, abstol)
            jr, ja = jcommon.resolve_tols(np.dtype(dt), reltol, abstol)
            assert (float(pr), float(pa)) == (float(jr), float(ja))
            assert _name(pr.dtype) == np.dtype(jr.dtype).name
            r0 = torch.tensor(2.5, dtype=pr.dtype)
            assert float(pcommon.tolerance(r0, pr, pa)) == float(
                jcommon.tolerance(jnp.asarray(2.5, jr.dtype), jr, ja))


def test_history_copy_behaves_like_jax(rng):
    buf = np.abs(rng.standard_normal(10))
    hs = []
    for cls in (ConvergenceHistory, JHistory):
        h = cls(partial=False, restart=4)
        h.iters, h.isconverged, h.mvps = 6, True, 7
        h.set_series("resnorm", buf, 6)
        h["reltol"] = 1e-6
        hs.append(h)
    p, j = hs
    assert repr(p) == repr(j)
    np.testing.assert_array_equal(p["resnorm"], j["resnorm"])
    assert ((p.niters(), p.nprods(), p.nrests())
            == (j.niters(), j.nprods(), j.nrests()))
    assert list(p.keys()) == list(j.keys()) and "reltol" in p
    assert p.plot() == j.plot()


def test_make_history_materializes_device_buffers():
    res = pcommon.SolveResult(
        x=torch.zeros(3), iters=torch.tensor(2), converged=torch.tensor(True),
        resnorm=torch.tensor(0.5),
        log={"resnorm": (torch.tensor([3.0, 0.5, 0.0]), torch.tensor(2))})
    h = pcommon.make_history(res, mv_per_iter=1.0, mv_initial=1,
                             extra_counters={"restarts": torch.tensor(1)})
    assert (h.iters, h.mvps, h.isconverged, h.restarts) == (2, 3, True, 1)
    np.testing.assert_array_equal(h["resnorm"], [3.0, 0.5])


def test_with_highest_precision_turns_tf32_off_and_restores():
    seen = []

    @pcommon.with_highest_precision
    def core():
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision()))
        raise KeyError("inside")

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(KeyError):
            core()
        assert seen == [(False, False, "highest")]
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before[:2]
        torch.set_float32_matmul_precision(before[2])


def test_run_chunked_freezes_state_at_done():
    """A toy step: the counter stops at 11 whatever the chunk."""
    def step(s, live):
        return s + live.to(s.dtype)

    def done(s):
        return s >= 11

    for chunk in (1, 2, 8, 16, 32, 256):
        out = pcommon.run_chunked(step, done, torch.tensor(0), chunk=chunk)
        assert int(out) == 11


# (live steps, chunk, steps run): the phases through the last live step and
# one more; phase edges (8, 24, 40, 56, 248, 504) and one step either side
STEPS_RUN = [
    (0, 1, 0), (1, 1, 1), (8, 1, 8), (9, 1, 9),
    (0, 8, 0), (1, 8, 16), (7, 8, 16), (8, 8, 16), (9, 8, 24),
    (16, 8, 24), (17, 8, 32),
    (0, 16, 0), (1, 16, 24), (8, 16, 24), (9, 16, 40), (23, 16, 40),
    (24, 16, 40), (25, 16, 56), (40, 16, 56), (41, 16, 72),
    (0, 32, 0), (1, 32, 24), (8, 32, 24), (9, 32, 56), (23, 32, 56),
    (24, 32, 56), (25, 32, 88), (56, 32, 88), (57, 32, 120),
    (0, 256, 0), (1, 256, 24), (8, 256, 24), (9, 256, 56), (247, 256, 504),
    (248, 256, 504), (249, 256, 760), (504, 256, 760), (505, 256, 1016),
]


def _counted_run(iters, chunk, **kw):
    """A toy solve of ``iters`` live steps: (steps run, its final state)."""
    ran = [0]

    def step(s, live):
        ran[0] += 1
        return s + live.to(s.dtype)

    out = pcommon.run_chunked(step, lambda s: s >= iters, torch.tensor(0),
                              chunk=chunk, **kw)
    return ran[0], int(out)


@pytest.mark.parametrize("iters,chunk,want", STEPS_RUN)
def test_chunked_steps_are_the_steps_run_chunked_runs(iters, chunk, want):
    assert pcommon.chunked_steps(iters, chunk) == want
    assert _counted_run(iters, chunk) == (want, iters)


@pytest.mark.parametrize("iters,chunk,want", [
    (0, 8, 0), (1, 8, 8), (8, 8, 8), (9, 8, 16),
    (0, 4, 0), (1, 4, 4), (4, 4, 4), (5, 4, 8), (9, 16, 24)])
def test_a_step_that_reads_the_host_runs_no_phase_past_the_last(iters, chunk,
                                                                want):
    """``step_reads_host`` (LOBPCG, svdl): the exit read after each phase
    waits for it, so no phase runs past the one of the last live step."""
    assert pcommon.chunked_steps(iters, chunk, step_reads_host=True) == want
    assert _counted_run(iters, chunk, step_reads_host=True) == (want, iters)


@pytest.mark.parametrize("chunk", [1, 8, 16, 256])
def test_run_chunked_keeps_no_earlier_state_alive(chunk):
    """While a step runs, no state before the one it was given is alive:
    the loop holds no phase's first state (on the card, a solve's vectors
    twice over)."""
    class State:
        def __init__(self, k):
            self.k = k

    earlier = []

    def step(s, live):
        assert all(r() is None for r in earlier)
        earlier.append(weakref.ref(s))
        return State(s.k + live.to(s.k.dtype))

    out = pcommon.run_chunked(step, lambda s: s.k >= 50,
                              State(torch.tensor(0)), chunk=chunk)
    assert int(out.k) == 50 and len(earlier) == pcommon.chunked_steps(50, chunk)


class _ReplayedPhase:
    """A stand-in for a captured phase: replayed, it runs the phase's steps
    on the static state in place, as the graph's last nodes copy them."""

    def __init__(self, graphs, step, done, c):
        self.graphs, self.step, self.done, self.c = graphs, step, done, c

    def replay(self):
        S = s = self.graphs.static
        for _ in range(self.c):
            s = self.step(s, ~self.done(s))
        for dst, src in zip(S, s):
            dst.copy_(src)


@pytest.mark.parametrize("live", [0, 1, 8, 9, 50, 56, 57])
def test_replayed_phases_follow_the_eager_schedule(monkeypatch, live):
    """``StepGraphs.run`` (the mesh's replayed phases, here with a phase
    that replays on the CPU) runs the eager route's phases, reads the same
    late exit flags and returns the same state: ``chunked_steps`` steps in
    its replays, a capture per phase length."""
    from collections import Counter, namedtuple
    from types import SimpleNamespace

    def capture(self, step, done, c):
        self.graphs[c] = (_ReplayedPhase(self, step, done, c), {})
        return self.graphs[c]

    monkeypatch.setattr(pcommon.StepGraphs, "_capture", capture)
    State = namedtuple("State", "k x")

    def step(s, live_):
        return State(s.k + live_.to(s.k.dtype),
                     torch.where(live_, 2 * s.x + 1, s.x))

    def done(s):
        return s.k >= live

    start = State(torch.tensor(0), torch.zeros(3))
    mesh = SimpleNamespace(counts=Counter(), device=torch.device("cpu"))
    graphs = pcommon.StepGraphs(mesh)
    got = pcommon.run_chunked(step, done, start, chunk=16, graphs=graphs)
    want = pcommon.run_chunked(step, done, start, chunk=16)
    assert int(got.k) == int(want.k) == live
    assert torch.equal(got.x, want.x) and int(start.k) == 0
    assert mesh.counts["replay_steps"] == pcommon.chunked_steps(live, 16)
    assert sorted(graphs.graphs) == sorted(
        {8, 16} if mesh.counts["replay_steps"] > 8 else
        ({8} if live else set()))


@pytest.mark.parametrize("flagged", [1, 2, 3])
def test_run_chunked_exit_is_phase_k_minus_1s_flag(flagged):
    """A step that ignores its mask, and a ``done`` that holds only at the
    end of phase ``flagged`` (8, 24, 40 steps at chunk 16): the host reads
    that flag after it has queued the next phase, so the loop stops after
    phase ``flagged + 1``, though the flag after that phase is false; every
    phase-end flag is evaluated once, the last one never read.  With
    ``step_reads_host`` the read after phase ``flagged`` stops it there."""
    ends = [8, 24, 40, 56, 72]
    seen = []

    def step(s, live):
        return s + 1

    def done(s):
        seen.append(int(s))
        return s == ends[flagged - 1]

    out = pcommon.run_chunked(step, done, torch.tensor(0), chunk=16)
    assert int(out) == ends[flagged]
    # the read before phase 1, the live masks (every state but the last)
    # and one flag at each phase's end
    assert sorted(seen) == sorted([0] + list(range(ends[flagged]))
                                  + ends[:flagged + 1])
    seen.clear()
    out = pcommon.run_chunked(step, done, torch.tensor(0), chunk=16,
                              step_reads_host=True)
    assert int(out) == ends[flagged - 1]


def test_lobpcg_and_svdl_keep_the_waiting_exit_read(monkeypatch):
    """LOBPCG and svdl, whose steps read the host (``eigh``, ``svd``), make
    no late exit flags: their exit read after each phase waits for it.  CG
    makes one set a solve."""
    made = []
    real = pcommon._ExitFlags

    def counted():
        made.append(1)
        return real()

    monkeypatch.setattr(pcommon, "_ExitFlags", counted)
    A = torch.diag(torch.linspace(1.0, 10.0, 60, dtype=torch.float64))
    X0 = torch.randn(60, 2, generator=torch.Generator().manual_seed(0),
                     dtype=torch.float64)
    assert pits.lobpcg(A, X0, tol=1e-4, maxiter=200).converged
    pits.svdl(A, nsv=2)
    assert made == []
    pits.cg(A, torch.ones(60, dtype=torch.float64))
    assert made == [1]


def test_solver_iterator_protocol():
    it = pcommon.SolverIterator(torch.tensor(0), step=lambda s: s + 1,
                                done=lambda s: s >= 3, extract=lambda s: 10 * s,
                                get_x=lambda s: -s)
    assert [int(v) for v in it] == [10, 20, 30]
    assert int(it.x) == -3


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "iterativesolvers_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "tools").glob("*.py"))
    assert len(files) > 15
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "iterativesolvers_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_default_device_is_the_card():
    """``laplacian(8, 2)`` with the default device raises on a torch
    without CUDA: the port never runs quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this torch has CUDA: the default device works here")
    with pytest.raises((AssertionError, RuntimeError)):
        pits.laplacian(8, 2)
    with pytest.raises((AssertionError, RuntimeError)):
        pits.cg(pits.FunctionOperator(lambda v: v, (4, 4), "float32"),
                np.ones(4, np.float32))
