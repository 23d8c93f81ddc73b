"""MINRES for Hermitian (or skew-Hermitian) indefinite systems — port of
``iterativesolvers_tpu/solvers/minres.py``.

The Lanczos 3-term recurrence with two sliding Givens rotations and a
W = V R^{-1} recurrence (src/minres.jl:97-159).  The reference's
``iteration > 1`` / ``> 2`` guards vanish: buffers start at zero and
rotations as identities, so the guarded updates are exact no-ops in the
first iterations and the step has no branch.

``skew_hermitian=True`` keeps the Hessenberg column complex and flips its
symmetry ``H2 <- -H4`` (src/minres.jl:46,110,153).

The residual estimate is ``|rhs[1]|`` after rotation (src/minres.jl:156) — the
true residual norm is not formed (no extra reduction per iteration).  Per
iteration: one ``op.mv`` and two reductions (the projection and the norm),
each allreduced on a row-sharded operator (``op.mesh``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.givens import givens
from ..utils.dtypes import real_dtype, solve_dtype
from .common import (CHUNK, SolveResult, SolverIterator, live_print, log_at,
                     make_history, norm, prepare, run_chunked, select,
                     tolerance, vdot, with_highest_precision)

__all__ = ["minres", "minres_iterator"]


class MINRESState(NamedTuple):
    x: torch.Tensor
    v_prev: torch.Tensor
    v_curr: torch.Tensor
    w_prev: torch.Tensor
    w_curr: torch.Tensor
    H2: torch.Tensor          # sub/super-diagonal carried to the next iteration
    rhs1: torch.Tensor        # active rhs entry
    c_prev: torch.Tensor
    s_prev: torch.Tensor
    c_curr: torch.Tensor
    s_curr: torch.Tensor
    residual: torch.Tensor
    tol: torch.Tensor
    k: torch.Tensor
    resnorm_log: torch.Tensor


def _conj(t):
    return t.conj() if t.is_complex() else t


def _minres_init(op, b, x0, reltol, abstol, maxiter, initially_zero, skew):
    dtype = solve_dtype(op.dtype, b.dtype)
    x = x0.to(dtype)
    r = b.to(dtype) if initially_zero else b.to(dtype) - op.mv(x)
    resnorm = norm(r, op.mesh)
    tol = tolerance(resnorm, reltol, abstol)
    safe = torch.where(resnorm == 0, 1, resnorm)
    # rotations live in the Hessenberg dtype: real for Hermitian problems
    # (the Lanczos tridiagonal is real), complex for skew-Hermitian ones
    hdtype = dtype if skew else real_dtype(dtype)
    dev = x.device

    def scalar(v):
        return torch.full((), v, dtype=hdtype, device=dev)

    return MINRESState(
        x=x,
        v_prev=torch.zeros_like(x),
        v_curr=r / safe,
        w_prev=torch.zeros_like(x),
        w_curr=torch.zeros_like(x),
        H2=scalar(0),
        rhs1=resnorm.to(hdtype),
        c_prev=scalar(1), s_prev=scalar(0),
        c_curr=scalar(1), s_curr=scalar(0),
        residual=resnorm,
        tol=tol,
        k=torch.zeros((), dtype=torch.int64, device=dev),
        resnorm_log=torch.zeros((max(maxiter, 1),), dtype=real_dtype(dtype),
                                device=dev),
    )


def _minres_step(op, s: MINRESState, skew: bool, live=None,
                 log_in_place=False) -> MINRESState:
    """One MINRES step; masked by the 0-d bool ``live`` (None: unmasked),
    where the returned state equals ``s``.  The tensors of ``s`` are never
    written (the log only when ``log_in_place``)."""
    mesh = op.mesh
    # Lanczos: v_next = A v_curr - H2 * v_prev, orthogonalized against v_curr
    v_next = op.mv(s.v_curr) - s.H2 * s.v_prev
    proj = vdot(s.v_curr, v_next, mesh)
    H3 = proj if skew else proj.real
    v_next = v_next - proj * s.v_curr
    H4 = norm(v_next, mesh)
    v_next = v_next / torch.where(H4 == 0, 1, H4)

    # sliding rotations (no-ops in iterations 1-2: identities and zeros)
    H1 = s.s_prev * s.H2
    H2 = s.c_prev * s.H2
    tmp = -_conj(s.s_curr) * H2 + s.c_curr * H3
    H2 = s.c_curr * H2 + s.s_curr * H3
    H3 = tmp

    c, s_rot, H3 = givens(H3, H4.to(tmp.dtype))
    rhs2 = -_conj(s_rot) * s.rhs1
    rhs1 = c * s.rhs1

    # W = V R^{-1} recurrence
    w_next = (s.v_curr - H2 * s.w_curr - H1 * s.w_prev) / torch.where(
        H3 == 0, 1, H3)
    x = s.x + rhs1 * w_next

    residual = rhs2.abs().to(s.residual.dtype)
    new = MINRESState(
        x=x,
        v_prev=s.v_curr,
        v_curr=v_next,
        w_prev=s.w_curr,
        w_curr=w_next,
        H2=(-H4 if skew else H4).to(s.H2.dtype),
        rhs1=rhs2.to(s.rhs1.dtype),
        c_prev=s.c_curr,
        s_prev=s.s_curr,
        c_curr=c.to(s.c_curr.dtype),
        s_curr=s_rot.to(s.s_curr.dtype),
        residual=residual,
        tol=s.tol,
        k=s.k + 1,
        resnorm_log=log_at(s.resnorm_log, s.k, residual, live, log_in_place),
    )
    return select(live, new, s)


def _minres_done(state: MINRESState, maxiter: int):
    return (state.k >= maxiter) | (state.residual <= state.tol)


@torch.no_grad()
@with_highest_precision
def _minres_core(op, b, x0, reltol, abstol, maxiter, initially_zero, skew,
                 verbose=False, chunk=CHUNK):
    state0 = _minres_init(op, b, x0, reltol, abstol, maxiter, initially_zero,
                          skew)
    final = run_chunked(
        lambda s, live: _minres_step(op, s, skew, live, log_in_place=True),
        lambda s: _minres_done(s, maxiter),
        state0, chunk=chunk,
        on_phase=live_print(lambda s: (s.resnorm_log, s.k)) if verbose
        else None,
    )
    return SolveResult(
        x=final.x,
        iters=final.k,
        converged=final.residual <= final.tol,
        resnorm=final.residual,
        log={"resnorm": (final.resnorm_log, final.k)},
    )


def minres(
    A,
    b,
    *,
    x0=None,
    skew_hermitian: bool = False,
    abstol: float | None = None,
    reltol: float | None = None,
    maxiter: int | None = None,
    log: bool = False,
    verbose: bool = False,
    chunk: int = CHUNK,
):
    """Solve A x = b for Hermitian (or skew-Hermitian) A
    (~ minres/minres!, src/minres.jl:161-244).  ``chunk``: as ``cg``'s."""
    p = prepare(A, b, x0, None, abstol, reltol, maxiter)
    res = _minres_core(p.op, p.b, p.x0, p.reltol, p.abstol, p.maxiter,
                       p.initially_zero, bool(skew_hermitian),
                       verbose=bool(verbose), chunk=int(chunk))
    if not log:
        return res.x
    history = make_history(
        res, mv_per_iter=1.0, mv_initial=0 if p.initially_zero else 1)
    history["abstol"] = float(p.abstol)
    history["reltol"] = float(p.reltol)
    return res.x, history


def minres_iterator(A, b, *, x0=None, skew_hermitian=False, abstol=None,
                    reltol=None, maxiter=None) -> SolverIterator:
    """Eager MINRES iterator: yields the residual estimate each step."""
    p = prepare(A, b, x0, None, abstol, reltol, maxiter)
    skew = bool(skew_hermitian)
    with torch.no_grad():
        state0 = _minres_init(p.op, p.b, p.x0, p.reltol, p.abstol, p.maxiter,
                              p.initially_zero, skew)

    @torch.no_grad()
    @with_highest_precision
    def step(s):
        return _minres_step(p.op, s, skew)

    return SolverIterator(state0, step=step,
                          done=lambda s: _minres_done(s, p.maxiter),
                          extract=lambda s: s.residual)
