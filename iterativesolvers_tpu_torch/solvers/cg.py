"""Conjugate Gradient (CG / PCG) — port of ``iterativesolvers_tpu/solvers/cg.py``.

Numerics mirror the reference (src/cg.jl:43-96):

    c = Pl^{-1} r                  (identity Pl: c = r, so the PCG recurrence
    rho = <c, r>                    reduces to the plain CG one, src/cg.jl:50-51)
    beta = rho / rho_prev
    u = c + beta * u
    c = A u                        <- the SpMV, fused with <u, Au>
    alpha = rho / <u, c>
    x += alpha u;  r -= alpha c
    residual = |r|

Per iteration: 1 SpMV + 2 global reductions (<u,c> and |r|; +1 for <c,r> when
preconditioned).  On a row-sharded operator (``op.mesh``, parallel/) every
reduction is allreduced over the mesh, so the scalars, and the host's exit
decision from them, are the same on every rank.

A real f32 solve vector takes the step's vector work in the launches of
``ops/cuda_cg.py`` (their plain versions on the CPU): without a
preconditioner ``rho`` is then the square of the state's residual, the
reference's ``it.residual^2`` (src/cg.jl:50-51), where the eager step sums
<r, r>.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..operators.preconditioners import is_identity
from ..ops import cuda_cg
from ..utils.dtypes import real_dtype, solve_dtype
from ..utils.profiling import span
from .common import (CHUNK, SolveResult, SolverIterator, log_at, make_history,
                     norm, prepare, print_resnorms, run_chunked, step_graphs,
                     tolerance, vdot, with_highest_precision)

__all__ = ["cg", "cg_iterator", "CGState"]


class CGState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    u: torch.Tensor
    residual: torch.Tensor     # |r| (real)
    rho: torch.Tensor          # <Pl^{-1} r, r> of previous iteration
    k: torch.Tensor            # iteration counter (int64, 0-d)
    tol: torch.Tensor
    resnorm_log: torch.Tensor  # (maxiter,) real


def _cg_init(op, b, x0, reltol, abstol, maxiter, initially_zero):
    dtype = solve_dtype(op.dtype, b.dtype)
    x = x0.to(dtype)
    r = b.to(dtype) if initially_zero else b.to(dtype) - op.mv(x)
    residual = norm(r, op.mesh)
    tol = tolerance(residual, reltol, abstol)
    return CGState(
        x=x,
        r=r,
        u=torch.zeros_like(x),
        residual=residual,
        rho=torch.ones((), dtype=dtype, device=x.device),
        k=torch.zeros((), dtype=torch.int64, device=x.device),
        tol=tol,
        # max(maxiter, 1): the masked log write needs one slot at maxiter=0
        resnorm_log=torch.zeros((max(maxiter, 1),), dtype=real_dtype(dtype),
                                device=x.device),
    )


def _cg_step(op, Pl, state: CGState, live, log_in_place=False) -> CGState:
    """One CG step, masked by the 0-d bool tensor ``live``: where it is
    false the returned state equals ``state``.

    The vectors of ``state`` are never written.  The residual log is copied
    first, unless ``log_in_place``: only ``cg``'s own loop, which holds no
    earlier state, writes the log in place, to avoid a copy of ``maxiter``
    values per step.  Under a profiler the preconditioner's apply is a span
    ``its.precond`` and the product a span ``its.spmv``.

    A contiguous 1-D f32 solve vector (``ops/cuda_cg.takes``; one card or
    a mesh) takes the step's vector work in ``ops/cuda_cg.py``'s launches,
    their plain versions on the CPU (:func:`_vector_step`); every other
    solve vector the eager step below.  The eager step masks its scalar
    coefficients (``beta -> 1``, ``c -> 0``, ``alpha -> 0``), so it costs no
    extra pass over a vector; it relies on the vectors being finite, which
    they are unless the solve diverged."""
    with span("its.precond"):
        c = Pl.ldiv(state.r)
    if cuda_cg.takes(state.x, state.r, state.u, c):
        return _vector_step(op, Pl, state, c, live, log_in_place)
    rho = vdot(c, state.r, op.mesh)
    beta = torch.where(live, rho / state.rho, 1.0)
    keep = live.to(c.dtype)
    u = torch.addcmul(beta * state.u, keep, c)      # c + beta u, or u
    with span("its.spmv"):
        c, sigma = op.mv_dot(u)
    alpha = torch.where(live, rho / sigma, 0.0)
    x = torch.addcmul(state.x, alpha, u)
    r = torch.addcmul(state.r, alpha, c, value=-1)
    residual, k, log = _advance(state, norm(r, op.mesh), live, log_in_place)
    return CGState(x=x, r=r, u=u, residual=residual,
                   rho=torch.where(live, rho, state.rho), k=k,
                   tol=state.tol, resnorm_log=log)


def _advance(state: CGState, residual, live, log_in_place):
    """The new state's ``(residual, k, resnorm_log)`` after a step whose
    new residual norm is ``residual``, masked by ``live`` (``_cg_step``)."""
    residual = torch.where(live, residual, state.residual)
    log = log_at(state.resnorm_log, state.k, residual, live, log_in_place)
    return residual, state.k + live.to(state.k.dtype), log


def _vector_step(op, Pl, state: CGState, c, live, log_in_place) -> CGState:
    """``_cg_step`` on a contiguous 1-D f32 solve vector, ``c`` = Pl^{-1} r
    given: the direction in one launch (PCG: after <c, r> in one, allreduced
    on a mesh; CG: rho = residual^2, the reference's unpreconditioned
    recurrence, so no reduction before the product), the operator's
    ``mv_dot``, then the update of x and r with |r|^2 in one.  On one card
    that launch also writes the residual, the count and the log slot; on a
    mesh it gives this rank's |r|^2, which is allreduced here.  The masked
    outputs are copies of the state's bits."""
    mesh = op.mesh
    if is_identity(Pl):
        u, rho = cuda_cg.cg_direction(c, state.u, state.residual, state.rho,
                                      live, square=True)
    else:
        dot = cuda_cg.cg_rho(c, state.r)
        u, rho = cuda_cg.cg_direction(
            c, state.u, dot if mesh is None else mesh.all_reduce(dot),
            state.rho, live)
    with span("its.spmv"):
        c, sigma = op.mv_dot(u)
    if not cuda_cg.takes(u, c):
        # a product outside the solve dtype (a FunctionOperator's)
        c, sigma = c.to(u.dtype).contiguous(), sigma.to(u.dtype)
    if mesh is None:
        log = state.resnorm_log if log_in_place else state.resnorm_log.clone()
        x, r, residual, k = cuda_cg.cg_update(
            state.x, u, state.r, c, rho, sigma, live, state.residual,
            state.k, log)
    else:
        x, r, rr = cuda_cg.cg_update(state.x, u, state.r, c, rho, sigma,
                                     live)
        residual, k, log = _advance(state, torch.sqrt(mesh.all_reduce(rr)),
                                    live, log_in_place)
    return CGState(x=x, r=r, u=u, residual=residual, rho=rho, k=k,
                   tol=state.tol, resnorm_log=log)


def _cg_done(state: CGState, maxiter):
    return (state.k >= maxiter) | (state.residual <= state.tol)


def _graphs(op, Pl, state):
    """The CUDA graphs that replay the solve's phases, on an operator whose
    steps may be captured (``common.step_graphs``: a mesh of several cards);
    unpreconditioned solves only, as a preconditioner's apply may read the
    host.  None: the steps are enqueued one by one."""
    if not is_identity(Pl):
        return None
    x = state.x
    return step_graphs(op, x.dtype, ("cg", x.dtype, tuple(x.shape)))


@torch.no_grad()
@with_highest_precision
def _cg_solve(op, b, x0, Pl, reltol, abstol, maxiter, initially_zero,
              chunk=CHUNK):
    state0 = _cg_init(op, b, x0, reltol, abstol, maxiter, initially_zero)
    graphs = _graphs(op, Pl, state0)
    # replayed steps read the limit from a tensor the graphs hold
    limit = maxiter if graphs is None else graphs.limit(maxiter)
    final = run_chunked(
        lambda s, live: _cg_step(op, Pl, s, live, log_in_place=True),
        lambda s: _cg_done(s, limit),
        state0,
        chunk=chunk,
        graphs=graphs,
    )
    return SolveResult(
        x=final.x,
        iters=final.k,
        converged=final.residual <= final.tol,
        resnorm=final.residual,
        log={"resnorm": (final.resnorm_log, final.k)},
    )


def cg(
    A,
    b,
    *,
    x0=None,
    Pl=None,
    abstol: float | None = None,
    reltol: float | None = None,
    maxiter: int | None = None,
    log: bool = False,
    verbose: bool = False,
    chunk: int = CHUNK,
):
    """Solve A x = b with (preconditioned) conjugate gradients.

    Mirrors ``cg`` / ``cg!`` (src/cg.jl:162,209-242): pass ``x0`` for the
    in-place form's warm start; returns ``x`` or ``(x, ConvergenceHistory)``
    when ``log=True``.  The solve runs on the operator's device; a numpy or
    host ``b`` / ``x0`` is moved there.

    ``chunk``: the steps of a phase of the masked chunked loop, after which
    the host reads the exit (``common.run_chunked``: one phase late, so the
    card keeps working; ``chunk <= 1`` waits for it before every step).
    Numerics are identical at any value.  ``verbose`` prints the residual of every
    iteration after the solve.
    """
    op, b, x0, Pl, reltol_, abstol_, maxiter, initially_zero = prepare(
        A, b, x0, Pl, abstol, reltol, maxiter)
    res = _cg_solve(op, b, x0, Pl, reltol_, abstol_, maxiter, initially_zero,
                    chunk=int(chunk))
    if verbose:
        print_resnorms(res)
    if not log:
        return res.x
    history = make_history(
        res, mv_per_iter=1.0, mv_initial=0 if initially_zero else 1
    )
    history["abstol"] = float(abstol_)
    history["reltol"] = float(reltol_)
    return res.x, history


def cg_iterator(
    A,
    b,
    *,
    x0=None,
    Pl=None,
    abstol: float | None = None,
    reltol: float | None = None,
    maxiter: int | None = None,
) -> SolverIterator:
    """Eager CG iterator (~ ``cg_iterator!``, src/cg.jl:120-155): yields the
    residual norm each step; ``.state`` is inspectable/replaceable between
    steps and serves as a checkpoint (a step never writes the tensors of the
    state it was given)."""
    op, b, x0, Pl, reltol_, abstol_, maxiter, initially_zero = prepare(
        A, b, x0, Pl, abstol, reltol, maxiter)
    with torch.no_grad():
        state0 = _cg_init(op, b, x0, reltol_, abstol_, maxiter, initially_zero)
    live = torch.ones((), dtype=torch.bool, device=op.device)

    @torch.no_grad()
    @with_highest_precision
    def step(s):
        return _cg_step(op, Pl, s, live)

    return SolverIterator(
        state0,
        step=step,
        done=lambda s: _cg_done(s, maxiter),
        extract=lambda s: s.residual,
    )
