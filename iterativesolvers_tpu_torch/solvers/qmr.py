"""QMR — Quasi-Minimal Residual for general nonsymmetric systems (port of
``iterativesolvers_tpu/solvers/qmr.py``).

Two-sided (non-Hermitian) Lanczos (``LanczosDecomp``, src/qmr.jl:5-99, Saad
Algorithm 7.1) and a MINRES-style sliding Givens QR of the tridiagonal
(src/qmr.jl:100-228).  Needs an adjoint matvec (``op.rmv``): per iteration
one ``op.mv`` and one ``op.rmv`` (on a stencil, the kernel with ``conj=True``)
and three reductions.

Breakdown handling mirrors the reference: when ``delta = sqrt(|<v,w>|)``
vanishes the Lanczos recurrence stops (src/qmr.jl:82-86); divisions are
guarded so the step stays finite, the rotated rhs becomes 0 and the loop
ends "converged" with the last iterate.

The residual estimate is the rotated-rhs tail ``|g2|`` (Proposition 7.3 of
Saad, src/qmr.jl:210-212).  The reference's ``lookahead`` kwarg is
accepted-but-unused there (src/qmr.jl:125,269) and is not replicated.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.givens import givens
from ..utils.dtypes import real_dtype, solve_dtype
from .common import (SolveResult, SolverIterator, live_print, log_at,
                     make_history, norm, prepare, run_chunked, select,
                     tolerance, vdot, with_highest_precision)

__all__ = ["qmr", "qmr_iterator"]


class QMRState(NamedTuple):
    x: torch.Tensor
    v_prev: torch.Tensor   # v_m   (post-swap convention of the reference)
    v_curr: torch.Tensor   # v_{m+1}
    w_prev: torch.Tensor
    w_curr: torch.Tensor
    alpha: torch.Tensor
    beta_prev: torch.Tensor
    beta_curr: torch.Tensor
    delta: torch.Tensor
    g1: torch.Tensor
    c_prev: torch.Tensor
    s_prev: torch.Tensor
    c_curr: torch.Tensor
    s_curr: torch.Tensor
    p_prev: torch.Tensor
    p_curr: torch.Tensor
    residual: torch.Tensor
    tol: torch.Tensor
    k: torch.Tensor
    breakdown: torch.Tensor  # Lanczos breakdown delta == 0 (src/qmr.jl:82-86)
    resnorm_log: torch.Tensor


def _safe(x):
    return torch.where(x == 0, 1, x)


def _conj(t):
    return t.conj() if t.is_complex() else t


def _qmr_init(op, b, x0, reltol, abstol, maxiter, initially_zero):
    dtype = solve_dtype(op.dtype, b.dtype)
    x = x0.to(dtype)
    r = b.to(dtype) if initially_zero else b.to(dtype) - op.mv(x)
    resnorm = norm(r, op.mesh)
    v1 = r / _safe(resnorm)
    zeros = torch.zeros_like(x)
    dev = x.device

    def scalar(v):
        return torch.full((), v, dtype=dtype, device=dev)

    return QMRState(
        x=x,
        v_prev=zeros, v_curr=v1,
        w_prev=zeros, w_curr=v1,
        alpha=scalar(0), beta_prev=scalar(0), beta_curr=scalar(0),
        delta=scalar(0),
        g1=resnorm.to(dtype),
        c_prev=scalar(1), s_prev=scalar(0),
        c_curr=scalar(1), s_curr=scalar(0),
        p_prev=zeros, p_curr=zeros,
        residual=resnorm, tol=tolerance(resnorm, reltol, abstol),
        k=torch.zeros((), dtype=torch.int64, device=dev),
        breakdown=torch.zeros((), dtype=torch.bool, device=dev),
        resnorm_log=torch.zeros((max(maxiter, 1),), dtype=real_dtype(dtype),
                                device=dev),
    )


def _qmr_step(op, s: QMRState, live=None, log_in_place=False) -> QMRState:
    """One QMR step, masked by ``live`` as ``minres._minres_step``."""
    mesh = op.mesh
    dtype = s.x.dtype
    # --- two-sided Lanczos step (src/qmr.jl:62-99); the iteration > 1
    # guards are no-ops here because the coefficients start at zero
    v_next = op.mv(s.v_curr)
    alpha = vdot(v_next, s.w_curr, mesh)
    v_next = v_next - _conj(alpha) * s.v_curr - _conj(s.beta_curr) * s.v_prev
    w_next = op.rmv(s.w_curr) - alpha * s.w_curr - s.delta * s.w_prev
    vw = vdot(v_next, w_next, mesh)
    delta = torch.sqrt(vw.abs()).to(dtype)
    # Lanczos breakdown: stop like the reference (src/qmr.jl:82-86)
    breakdown = s.breakdown | (delta == 0)
    beta_prev = s.beta_curr
    beta_curr = vw / _safe(delta)
    v_next = v_next / _safe(delta)
    w_next = w_next / _safe(beta_curr)

    # --- QMR update (src/qmr.jl:160-215)
    H2 = _conj(beta_prev)
    H3 = _conj(alpha)
    H4 = delta
    H1 = s.s_prev * H2
    H2 = s.c_prev * H2
    tmp = -_conj(s.s_curr) * H2 + s.c_curr * H3
    H2 = s.c_curr * H2 + s.s_curr * H3
    H3 = tmp
    c, s_rot, H3 = givens(H3, H4)
    g2 = -_conj(s_rot) * s.g1
    g1 = c * s.g1

    p = (s.v_curr - H2 * s.p_curr - H1 * s.p_prev) / _safe(H3)
    x = s.x + g1 * p
    residual = g2.abs().to(s.residual.dtype)
    new = QMRState(
        x=x,
        v_prev=s.v_curr, v_curr=v_next,
        w_prev=s.w_curr, w_curr=w_next,
        alpha=alpha, beta_prev=beta_prev, beta_curr=beta_curr, delta=delta,
        g1=g2.to(dtype),
        c_prev=s.c_curr, s_prev=s.s_curr,
        c_curr=c.to(dtype), s_curr=s_rot.to(dtype),
        p_prev=s.p_curr, p_curr=p,
        residual=residual, tol=s.tol,
        k=s.k + 1,
        breakdown=breakdown,
        resnorm_log=log_at(s.resnorm_log, s.k, residual, live, log_in_place),
    )
    return select(live, new, s)


def _qmr_done(s: QMRState, maxiter: int):
    return (s.k >= maxiter) | (s.residual <= s.tol) | s.breakdown


@torch.no_grad()
@with_highest_precision
def _qmr_core(op, b, x0, reltol, abstol, maxiter, initially_zero,
              verbose=False, chunk=256):
    state0 = _qmr_init(op, b, x0, reltol, abstol, maxiter, initially_zero)
    final = run_chunked(
        lambda s, live: _qmr_step(op, s, live, log_in_place=True),
        lambda s: _qmr_done(s, maxiter), state0, chunk=chunk,
        on_phase=live_print(lambda s: (s.resnorm_log, s.k)) if verbose
        else None)
    return SolveResult(
        x=final.x,
        iters=final.k,
        converged=final.residual <= final.tol,
        resnorm=final.residual,
        log={"resnorm": (final.resnorm_log, final.k)},
    )


def qmr(
    A,
    b,
    *,
    x0=None,
    abstol: float | None = None,
    reltol: float | None = None,
    maxiter: int | None = None,
    log: bool = False,
    verbose: bool = False,
    chunk: int = 256,
):
    """Solve A x = b with QMR (~ qmr/qmr!, src/qmr.jl:230-297).  Needs an
    operator with an adjoint matvec (dense and sparse matrices and stencils
    provide it; a ``FunctionOperator`` needs ``rmatvec``).  ``chunk``: as
    ``cg``'s."""
    p = prepare(A, b, x0, None, abstol, reltol, maxiter)
    res = _qmr_core(p.op, p.b, p.x0, p.reltol, p.abstol, p.maxiter,
                    p.initially_zero, verbose=bool(verbose), chunk=int(chunk))
    if not log:
        return res.x
    history = make_history(
        res, mv_per_iter=1.0, mv_initial=0 if p.initially_zero else 1,
        mtv_per_iter=1.0)
    history["abstol"] = float(p.abstol)
    history["reltol"] = float(p.reltol)
    return res.x, history


def qmr_iterator(
    A,
    b,
    *,
    x0=None,
    abstol: float | None = None,
    reltol: float | None = None,
    maxiter: int | None = None,
) -> SolverIterator:
    """Eager QMR iterator (~ ``qmr_iterable!``, src/qmr.jl:120-140): yields
    the residual-norm estimate |g2| each step."""
    p = prepare(A, b, x0, None, abstol, reltol, maxiter)
    with torch.no_grad():
        state0 = _qmr_init(p.op, p.b, p.x0, p.reltol, p.abstol, p.maxiter,
                           p.initially_zero)

    @torch.no_grad()
    @with_highest_precision
    def step(s):
        return _qmr_step(p.op, s)

    return SolverIterator(state0, step=step,
                          done=lambda s: _qmr_done(s, p.maxiter),
                          extract=lambda s: s.residual)
