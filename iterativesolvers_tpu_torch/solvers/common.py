"""Solver driver protocol (port of ``iterativesolvers_tpu/solvers/common.py``).

Each solver defines a state ``NamedTuple`` of tensors, an ``init`` and a
``step``.  The classic API drives the step on the device through
:func:`run_chunked`, which reads the data-dependent exit back to the host only
once per phase; the iterator API (:class:`SolverIterator`) exposes the same
step eagerly, and its state doubles as a checkpoint.

Shared behavioral contract (SURVEY §2.3):
  * stopping: ``resnorm <= max(reltol * resnorm0, abstol)``
    with defaults ``reltol = sqrt(eps(real(T)))``, ``abstol = 0``
    (src/cg.jl:121-122,141)
  * ``maxiter = size(A, 2)`` default (src/cg.jl:123)
  * allocating form starts from x0 = 0 and skips the initial A*x product
    (``initially_zero``, src/cg.jl:132-139)
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..utils.dtypes import default_reltol, real_dtype
from ..utils.history import ConvergenceHistory

__all__ = [
    "SolveResult",
    "with_highest_precision",
    "tolerance",
    "norm",
    "vdot",
    "SolverIterator",
    "resolve_tols",
    "make_history",
    "run_chunked",
    "chunked_steps",
]


def norm(x):
    """2-norm, always real.  (Complex-safe: sums |x|^2.)"""
    return torch.linalg.vector_norm(x)


def vdot(a, b):
    """<a, b> with the first argument conjugated (Julia ``dot`` semantics)."""
    return torch.sum(a.conj() * b)


def tolerance(resnorm0, reltol, abstol):
    """max(reltol*|r0|, abstol) — src/cg.jl:141."""
    return torch.maximum(reltol * resnorm0, abstol)


def resolve_tols(dtype, reltol: Optional[float], abstol: Optional[float],
                 device=None):
    """(reltol, abstol) as 0-d tensors of the real solve dtype on ``device``."""
    if reltol is None:
        reltol = default_reltol(dtype)
    if abstol is None:
        abstol = 0.0
    rt = real_dtype(dtype)
    return (torch.tensor(float(reltol), dtype=rt, device=device),
            torch.tensor(float(abstol), dtype=rt, device=device))


class SolveResult(NamedTuple):
    """Uniform device-side result every solver returns from its core."""

    x: Any                  # solution (vector / matrix)
    iters: Any              # int — iterations performed
    converged: Any          # bool
    resnorm: Any            # final residual norm estimate
    log: dict               # name -> (buffer, nvalid) fixed-size series


def make_history(
    res: SolveResult,
    *,
    mv_per_iter: float = 1.0,
    mv_initial: int = 1,
    mtv_per_iter: float = 0.0,
    restart: Optional[int] = None,
    partial: bool = False,
    extra_counters: Optional[dict] = None,
) -> ConvergenceHistory:
    """Materialize a host ConvergenceHistory from device buffers."""
    h = ConvergenceHistory(partial=partial, restart=restart)
    iters = int(res.iters)
    h.iters = iters
    h.isconverged = bool(res.converged)
    h.mvps = int(round(mv_initial + mv_per_iter * iters))
    h.mtvps = int(round(mtv_per_iter * iters))
    if extra_counters:
        for k, v in extra_counters.items():
            setattr(h, k, int(v))
    for key, (buf, nvalid) in res.log.items():
        h.set_series(key, buf.detach().cpu().numpy(), int(nvalid))
    return h


class SolverIterator:
    """Eager iterator over a solver's step — the analogue of the reference's
    iterator protocol (docs/src/iterators.md:1-77).

    Yields a per-iteration value (typically the residual norm).  The caller
    may inspect/replace ``.state`` between steps (e.g. swap the RHS), exactly
    like mutating the reference's iterable struct.  A step returns a new
    state and changes no tensor of the state it was given, so an old
    ``.state`` stays a valid checkpoint.
    """

    def __init__(
        self,
        state,
        step: Callable,
        done: Callable,
        extract: Callable = lambda s: s,
        get_x: Callable | None = None,
    ):
        self.state = state
        self._step = step
        self._done = done
        self._extract = extract
        self._get_x = get_x

    def __iter__(self):
        return self

    def __next__(self):
        if bool(self._done(self.state)):
            raise StopIteration
        self.state = self._step(self.state)
        return self._extract(self.state)

    @property
    def x(self):
        st = self.state
        if self._get_x is not None:
            return self._get_x(st)
        return getattr(st, "x", None) if hasattr(st, "x") else st.X


@contextlib.contextmanager
def _highest_precision():
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(precision)


def with_highest_precision(f):
    """Run a solver core with TF32 off for matmuls and cuDNN: TF32 keeps
    about three decimal digits, fatal for Krylov orthogonalization and Gram
    matrices in f32.  The previous settings are restored on exit."""

    @functools.wraps(f)
    def g(*args, **kwargs):
        with _highest_precision():
            return f(*args, **kwargs)

    return g


_WARMUP = (8, 16, 32, 64, 128)


def _phases(chunk: int):
    """Phase lengths of :func:`run_chunked`: the warm-up ladder below
    ``chunk``, then ``chunk`` forever."""
    for c in _WARMUP:
        if c < chunk:
            yield c
    while True:
        yield chunk


def chunked_steps(iters: int, chunk: int = 256) -> int:
    """Steps :func:`run_chunked` executes, masked ones included, for a solve
    that stops after ``iters`` live steps."""
    if chunk <= 1:
        return int(iters)
    done = 0
    for c in _phases(chunk):
        if done >= iters:
            return done
        done += c


def run_chunked(step, done, state, chunk: int = 256):
    """Drive ``state = step(state, live)`` until ``done(state)``, reading the
    data-dependent exit back to the host only once per phase: every read
    waits for the device, so a check per step would idle the card between
    steps.

    Inside a phase every step runs, and ``live = ~done(state)`` is handed to
    it as a 0-d bool tensor on the device.  ``step`` must return ``state``
    unchanged where ``live`` is false, so no visible state advances past
    convergence: iteration counters and logs freeze exactly at convergence,
    and the numerics are identical at every ``chunk``; only the exit
    granularity changes.  How a step masks itself is the solver's choice
    (CG masks its scalar coefficients, which costs no extra pass over a
    vector; see ``cg._cg_step``).

    Phases follow the warm-up ladder 8, 16, 32, 64, 128 (those below
    ``chunk``), then ``chunk``: a solve converging at iteration ~10 should
    not run a full steady-state chunk of masked steps.  ``chunk <= 1``
    checks ``done`` on the host before every step.
    """
    if chunk <= 1:
        while not bool(done(state)):
            state = step(state, ~done(state))
        return state
    for c in _phases(chunk):
        if bool(done(state)):
            return state
        for _ in range(c):
            state = step(state, ~done(state))
