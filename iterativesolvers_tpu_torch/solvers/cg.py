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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.dtypes import real_dtype, solve_dtype
from .common import (SolveResult, SolverIterator, log_at, make_history,
                     norm, prepare, print_resnorms, run_chunked, tolerance,
                     vdot, with_highest_precision)

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

    The mask acts on the scalar coefficients (``beta -> 1``, ``c -> 0``,
    ``alpha -> 0``), so it costs no extra pass over a vector; it relies on the
    vectors being finite, which they are unless the solve diverged.  The
    vectors of ``state`` are never written.  The residual log is copied
    first, unless ``log_in_place``: only ``cg``'s own loop, which holds no
    earlier state, writes the log in place, to avoid a copy of
    ``maxiter`` values per step."""
    c = Pl.ldiv(state.r)
    rho = vdot(c, state.r, op.mesh)
    beta = torch.where(live, rho / state.rho, 1.0)
    keep = live.to(c.dtype)
    u = torch.addcmul(beta * state.u, keep, c)      # c + beta u, or u
    c, sigma = op.mv_dot(u)
    alpha = torch.where(live, rho / sigma, 0.0)
    x = torch.addcmul(state.x, alpha, u)
    r = torch.addcmul(state.r, alpha, c, value=-1)
    residual = torch.where(live, norm(r, op.mesh), state.residual)
    log = log_at(state.resnorm_log, state.k, residual, live, log_in_place)
    return CGState(
        x=x,
        r=r,
        u=u,
        residual=residual,
        rho=torch.where(live, rho, state.rho),
        k=state.k + live.to(state.k.dtype),
        tol=state.tol,
        resnorm_log=log,
    )


def _cg_done(state: CGState, maxiter: int):
    return (state.k >= maxiter) | (state.residual <= state.tol)


@torch.no_grad()
@with_highest_precision
def _cg_solve(op, b, x0, Pl, reltol, abstol, maxiter, initially_zero,
              chunk=256):
    state0 = _cg_init(op, b, x0, reltol, abstol, maxiter, initially_zero)
    final = run_chunked(
        lambda s, live: _cg_step(op, Pl, s, live, log_in_place=True),
        lambda s: _cg_done(s, maxiter),
        state0,
        chunk=chunk,
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
    chunk: int = 256,
):
    """Solve A x = b with (preconditioned) conjugate gradients.

    Mirrors ``cg`` / ``cg!`` (src/cg.jl:162,209-242): pass ``x0`` for the
    in-place form's warm start; returns ``x`` or ``(x, ConvergenceHistory)``
    when ``log=True``.  The solve runs on the operator's device; a numpy or
    host ``b`` / ``x0`` is moved there.

    ``chunk``: convergence-check granularity of the masked chunked loop (see
    ``common.run_chunked``); every check waits for the device.  Numerics are
    identical at any value.  ``verbose`` prints the residual of every
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
