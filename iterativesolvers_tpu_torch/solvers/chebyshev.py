"""Chebyshev iteration for SPD systems with known spectral bounds (port of
``iterativesolvers_tpu/solvers/chebyshev.py``).

The user supplies eigenvalue bounds (lmin, lmax) positionally
(src/chebyshev.jl:59,141); one SpMV and **no inner products** in the update,
only the stopping test's norm (allreduced on a row-sharded operator).

As in the JAX package, the standard Templates/Saad recurrence (the
reference drops the search direction's momentum, src/chebyshev.jl:46):

    beta_1 = 0,            alpha_1 = 1/d
    beta_2 = (c*alpha)^2/2, alpha_k = 1/(d - beta_k/alpha_{k-1})
    beta_k = (c*alpha/2)^2
    u = Pl^{-1} r + beta * u;  x += alpha*u;  r -= alpha*A*u

Left preconditioning only, like the reference; the residual history
materializes only when ``log=True``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.dtypes import real_dtype, solve_dtype
from .common import (SolveResult, SolverIterator, live_print, log_at,
                     make_history, norm, prepare, run_chunked, select,
                     tolerance, with_highest_precision)

__all__ = ["chebyshev", "chebyshev_iterator"]


class ChebyshevState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    u: torch.Tensor
    alpha: torch.Tensor
    residual: torch.Tensor
    tol: torch.Tensor
    k: torch.Tensor
    resnorm_log: torch.Tensor


def _cheb_init(op, b, x0, reltol, abstol, maxiter, initially_zero):
    dtype = solve_dtype(op.dtype, b.dtype)
    rdt = real_dtype(dtype)
    x = x0.to(dtype)
    r = b.to(dtype) if initially_zero else b.to(dtype) - op.mv(x)
    residual = norm(r, op.mesh)
    return ChebyshevState(
        x=x,
        r=r,
        u=torch.zeros_like(x),
        alpha=torch.zeros((), dtype=rdt, device=x.device),
        residual=residual,
        tol=tolerance(residual, reltol, abstol),
        k=torch.zeros((), dtype=torch.int64, device=x.device),
        resnorm_log=torch.zeros((max(maxiter, 1),), dtype=rdt,
                                device=x.device),
    )


def _cheb_step(op, Pl, d, half_c, s: ChebyshevState, live=None,
               log_in_place=False) -> ChebyshevState:
    """One Chebyshev step; ``d = (lmax + lmin) / 2`` and ``half_c = (lmax
    - lmin) / 4`` are 0-d tensors of the real dtype.  Masked by ``live`` as
    ``minres._minres_step``."""
    z = Pl.ldiv(s.r)
    # beta_1 = 0 (alpha starts at 0); beta_2 = (c alpha)^2 / 2;
    # beta_k = (c alpha / 2)^2 afterwards
    beta = torch.where(s.k == 1, 2 * (half_c * s.alpha) ** 2,
                       (half_c * s.alpha) ** 2)
    alpha = torch.where(
        s.k == 0, 1.0 / d,
        1.0 / (d - beta / torch.where(s.alpha == 0, 1, s.alpha)))
    u = z + beta * s.u
    c = op.mv(u)
    x = s.x + alpha * u
    r = s.r - alpha * c
    residual = norm(r, op.mesh)
    new = ChebyshevState(
        x=x, r=r, u=u, alpha=alpha, residual=residual, tol=s.tol, k=s.k + 1,
        resnorm_log=log_at(s.resnorm_log, s.k, residual, live, log_in_place))
    return select(live, new, s)


def _cheb_done(s: ChebyshevState, maxiter: int):
    return (s.k >= maxiter) | (s.residual <= s.tol)


def _bounds(lmin, lmax, dtype, device):
    rdt = real_dtype(dtype)
    return (torch.tensor((lmax + lmin) / 2, dtype=rdt, device=device),
            torch.tensor((lmax - lmin) / 4, dtype=rdt, device=device))


@torch.no_grad()
@with_highest_precision
def _cheb_core(op, b, x0, Pl, lmin, lmax, reltol, abstol, maxiter,
               initially_zero, verbose=False, chunk=256):
    state0 = _cheb_init(op, b, x0, reltol, abstol, maxiter, initially_zero)
    d, half_c = _bounds(lmin, lmax, state0.x.dtype, state0.x.device)
    final = run_chunked(
        lambda s, live: _cheb_step(op, Pl, d, half_c, s, live,
                                   log_in_place=True),
        lambda s: _cheb_done(s, maxiter), state0, chunk=chunk,
        on_phase=live_print(lambda s: (s.resnorm_log, s.k)) if verbose
        else None)
    return SolveResult(
        x=final.x,
        iters=final.k,
        converged=final.residual <= final.tol,
        resnorm=final.residual,
        log={"resnorm": (final.resnorm_log, final.k)},
    )


def chebyshev(
    A,
    b,
    lmin: float,
    lmax: float,
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
    """Solve A x = b by Chebyshev iteration given eigenvalue bounds
    (~ chebyshev/chebyshev!, src/chebyshev.jl:93-170).  ``chunk``: as
    ``cg``'s."""
    p = prepare(A, b, x0, Pl, abstol, reltol, maxiter)
    res = _cheb_core(p.op, p.b, p.x0, p.Pl, float(lmin), float(lmax),
                     p.reltol, p.abstol, p.maxiter, p.initially_zero,
                     verbose=bool(verbose), chunk=int(chunk))
    if not log:
        return res.x
    history = make_history(res, mv_per_iter=1.0,
                           mv_initial=0 if p.initially_zero else 1)
    history["abstol"] = float(p.abstol)
    history["reltol"] = float(p.reltol)
    return res.x, history


def chebyshev_iterator(
    A,
    b,
    lmin: float,
    lmax: float,
    *,
    x0=None,
    Pl=None,
    abstol: float | None = None,
    reltol: float | None = None,
    maxiter: int | None = None,
) -> SolverIterator:
    """Eager Chebyshev iterator (~ ``chebyshev_iterable!``,
    src/chebyshev.jl:59-91): yields the residual norm each step."""
    p = prepare(A, b, x0, Pl, abstol, reltol, maxiter)
    with torch.no_grad():
        state0 = _cheb_init(p.op, p.b, p.x0, p.reltol, p.abstol, p.maxiter,
                            p.initially_zero)
    d, half_c = _bounds(float(lmin), float(lmax), state0.x.dtype,
                        state0.x.device)

    @torch.no_grad()
    @with_highest_precision
    def step(s):
        return _cheb_step(p.op, p.Pl, d, half_c, s)

    return SolverIterator(state0, step=step,
                          done=lambda s: _cheb_done(s, p.maxiter),
                          extract=lambda s: s.residual)
