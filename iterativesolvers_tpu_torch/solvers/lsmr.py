"""LSMR — least squares via Golub-Kahan bidiagonalization, MINRES flavor
(port of ``iterativesolvers_tpu/solvers/lsmr.py``).

Fong & Saunders' method, MINRES on the normal equations
(src/lsmr.jl:18-21).  The double-rotation scheme (Qhat eliminating the
regularization λ, Q turning B to R, Qbar to Rbar, Qtilde for the ‖r‖
recurrences — src/lsmr.jl:178-233) runs as 0-d tensors of the state; a step
takes one ``op.mv`` and one ``op.rmv``.

istop protocol identical in structure to LSQR (src/lsmr.jl:274-281), but the
reference *breaks* at the first satisfied test (priority 7 down to 1) and
defines convergence as ``istop ∉ (3, 6, 7)`` (src/lsmr.jl:285).  On a
row-sharded operator every norm is allreduced over ``op.mesh``, as in
LSQR.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .common import (SolveResult, log_at, make_history, norm, run_chunked,
                     safe_inv, select, with_highest_precision)
from .lsqr import _istop, least_squares_setup, printer

__all__ = ["lsmr"]

_LOGS = ("test1_log", "test2_log", "test3_log")


class LSMRState(NamedTuple):
    x: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    h: torch.Tensor
    hbar: torch.Tensor
    alpha: torch.Tensor
    alphabar: torch.Tensor
    zeta: torch.Tensor
    zetabar: torch.Tensor
    rho: torch.Tensor
    rhobar: torch.Tensor
    cbar: torch.Tensor
    sbar: torch.Tensor
    # ||r|| estimation (src/lsmr.jl:137-144)
    betadd: torch.Tensor
    betad: torch.Tensor
    rhodold: torch.Tensor
    tautildeold: torch.Tensor
    thetatilde: torch.Tensor
    d: torch.Tensor
    # ||A||, cond(A) estimation (src/lsmr.jl:146-150)
    normA2: torch.Tensor
    maxrbar: torch.Tensor
    minrbar: torch.Tensor
    iter: torch.Tensor
    istop: torch.Tensor
    mtvps: torch.Tensor
    normb: torch.Tensor
    test1_log: torch.Tensor   # :rnorm
    test2_log: torch.Tensor   # :anorm
    test3_log: torch.Tensor   # :cnorm


def _lsmr_step(op, lam, atol, btol, ctol, maxiter, s: LSMRState, live=None):
    it = s.iter + 1

    # bidiagonalization step (src/lsmr.jl:166-176)
    u = op.mv(s.v) - s.alpha * s.u
    beta = norm(u, op.mesh)
    bpos = beta > 0
    u = u * safe_inv(beta)
    v_new = op.rmv(u) - beta * s.v
    alpha_new = norm(v_new, op.mesh)
    v = torch.where(bpos, v_new * safe_inv(alpha_new), s.v)
    alpha = torch.where(bpos, alpha_new, s.alpha)
    mtvps = s.mtvps + bpos.to(s.mtvps.dtype)

    # Qhat: eliminate lambda (src/lsmr.jl:178-181)
    alphahat = torch.hypot(s.alphabar, lam)
    chat = s.alphabar / alphahat
    shat = lam / alphahat

    # Q: B -> R (src/lsmr.jl:183-189)
    rhoold = s.rho
    rho = torch.hypot(alphahat, beta)
    c = alphahat / rho
    sn = beta / rho
    thetanew = sn * alpha
    alphabar = c * alpha

    # Qbar: R^T -> Rbar (src/lsmr.jl:191-200)
    rhobarold = s.rhobar
    zetaold = s.zeta
    thetabar = s.sbar * rho
    rhotemp = s.cbar * rho
    rhobar = torch.hypot(s.cbar * rho, thetanew)
    cbar = s.cbar * rho / rhobar
    sbar = thetanew / rhobar
    zeta = cbar * s.zetabar
    zetabar = -sbar * s.zetabar

    # update h, hbar, x (src/lsmr.jl:202-205)
    hbar = s.hbar * (-thetabar * rho / (rhoold * rhobarold)) + s.h
    x = s.x + (zeta / (rho * rhobar)) * hbar
    h = s.h * (-thetanew / rho) + v

    # ||r|| estimate (src/lsmr.jl:207-233)
    betaacute = chat * s.betadd
    betacheck = -shat * s.betadd
    betahat = c * betaacute
    betadd = -sn * betaacute

    thetatildeold = s.thetatilde
    rhotildeold = torch.hypot(s.rhodold, thetabar)
    ctildeold = s.rhodold / rhotildeold
    stildeold = thetabar / rhotildeold
    thetatilde = stildeold * rhobar
    rhodold = ctildeold * rhobar
    betad = -stildeold * s.betad + ctildeold * betahat

    tautildeold = (zetaold - thetatildeold * s.tautildeold) / rhotildeold
    taud = (zeta - thetatilde * tautildeold) / rhodold
    d = s.d + betacheck**2
    normr = torch.sqrt(d + (betad - taud) ** 2 + betadd**2)

    # ||A||, cond(A) (src/lsmr.jl:235-245)
    normA2 = s.normA2 + beta**2
    normA = torch.sqrt(normA2)
    normA2 = normA2 + alpha**2
    maxrbar = torch.maximum(s.maxrbar, rhobarold)
    minrbar = torch.where(it > 1, torch.minimum(s.minrbar, rhobarold),
                          s.minrbar)
    condA = (torch.maximum(maxrbar, rhotemp)
             / torch.minimum(minrbar, rhotemp))

    # convergence tests (src/lsmr.jl:247-281)
    normAr = torch.abs(zetabar)
    normx = norm(x, op.mesh)
    test1 = normr / s.normb
    test2 = normAr / (normA * normr)
    test3 = 1.0 / condA
    t1 = test1 / (1 + normA * normx / s.normb)
    rtol = btol + atol * normA * normx / s.normb

    # the reference breaks at the FIRST satisfied test in order 7,6,...,1
    # (src/lsmr.jl:274-281), so higher codes take priority — apply low-to-high
    # so later (higher) writes win.  (LSQR is the opposite: no breaks, so its
    # later/lower assignments win, src/lsqr.jl:256-269.)
    istop = _istop([(test1 <= rtol, 1), (test2 <= atol, 2),
                    (test3 <= ctol, 3), (1 + t1 <= 1, 4),
                    (1 + test2 <= 1, 5), (1 + test3 <= 1, 6),
                    (it >= maxiter, 7)])

    k = s.iter
    new = LSMRState(
        x=x, u=u, v=v, h=h, hbar=hbar,
        alpha=alpha, alphabar=alphabar,
        zeta=zeta, zetabar=zetabar, rho=rho, rhobar=rhobar,
        cbar=cbar, sbar=sbar,
        betadd=betadd, betad=betad, rhodold=rhodold,
        tautildeold=tautildeold, thetatilde=thetatilde, d=d,
        normA2=normA2, maxrbar=maxrbar, minrbar=minrbar,
        iter=it, istop=istop, mtvps=mtvps, normb=s.normb,
        test1_log=log_at(s.test1_log, k, test1, live, True),
        test2_log=log_at(s.test2_log, k, test2, live, True),
        test3_log=log_at(s.test3_log, k, test3, live, True),
    )
    return select(live, new, s, keep=_LOGS)


@torch.no_grad()
@with_highest_precision
def _lsmr_solve(op, b, x0, lam, atol, btol, ctol, maxiter, verbose):
    dtype = x0.dtype
    rt = lam.dtype
    dev = b.device

    # beta*u = b - A x0 ; alpha*v = A'u (src/lsmr.jl:113-120)
    u = b.to(dtype) - op.mv(x0)
    beta = norm(u, op.mesh)
    u = u * safe_inv(beta)
    v = op.rmv(u)
    alpha = norm(v, op.mesh)
    v = v * safe_inv(alpha)
    normAr0 = alpha * beta

    L = max(maxiter, 1)

    def full(val):
        return torch.full((), val, dtype=rt, device=dev)

    def i64(val):
        return torch.tensor(val, dtype=torch.int64, device=dev)

    zero, one = full(0.0), full(1.0)
    state0 = LSMRState(
        x=x0, u=u, v=v, h=v, hbar=torch.zeros_like(x0),
        alpha=alpha, alphabar=alpha,
        zeta=zero, zetabar=alpha * beta,
        rho=one, rhobar=one, cbar=one, sbar=zero,
        betadd=beta, betad=zero, rhodold=one,
        tautildeold=zero, thetatilde=zero, d=zero,
        normA2=alpha**2, maxrbar=zero,
        minrbar=full(torch.finfo(rt).max),  # ~ 1e100 (src/lsmr.jl:150)
        iter=i64(0), istop=i64(0), mtvps=i64(1),
        normb=beta,
        test1_log=torch.zeros((L,), dtype=rt, device=dev),
        test2_log=torch.zeros((L,), dtype=rt, device=dev),
        test3_log=torch.zeros((L,), dtype=rt, device=dev),
    )

    def done(s):
        return ~((s.iter < maxiter) & (s.istop == 0) & (normAr0 != 0))

    final = run_chunked(
        lambda s, live: _lsmr_step(op, lam, atol, btol, ctol, maxiter, s,
                                   live),
        done, state0,
        on_phase=printer("iter", ("test2_log", "test3_log", "test1_log"))
        if verbose else None)
    # converged = istop not in (3, 6, 7) (src/lsmr.jl:285)
    converged = (final.istop != 3) & (final.istop != 6) & (final.istop != 7)
    return SolveResult(
        x=final.x,
        iters=final.iter,
        converged=converged,
        resnorm=(final.test1_log[torch.clamp(final.iter - 1, min=0)]
                 * final.normb),
        log={
            "rnorm": (final.test1_log, final.iter),
            "anorm": (final.test2_log, final.iter),
            "cnorm": (final.test3_log, final.iter),
        },
    ), final.istop, final.mtvps


def lsmr(
    A,
    b,
    *,
    x0=None,
    lam: float = 0.0,
    atol: float = 1e-6,
    btol: float = 1e-6,
    conlim: float = 1e8,
    maxiter: int | None = None,
    log: bool = False,
    verbose: bool = False,
):
    """Solve min ‖Ax − b‖² + λ²‖x‖² (~ ``lsmr(!)``, src/lsmr.jl:1-94).

    Defaults mirror the reference (src/lsmr.jl:60-67): ``atol=btol=1e-6``,
    ``conlim=1e8``, ``maxiter = max(m, n)`` (``maximum(size(A))``).  The
    solve runs on the operator's device; ``verbose`` prints as ``lsqr``.
    """
    op, b, x0, maxiter, dtype, rt = least_squares_setup(A, b, x0, maxiter)
    ctol = 1.0 / conlim if conlim > 0 else 0.0

    def t(v):
        return torch.tensor(float(v), dtype=rt, device=b.device)

    res, istop, mtvps = _lsmr_solve(op, b, x0.to(dtype), t(lam), t(atol),
                                    t(btol), t(ctol), maxiter, bool(verbose))
    if not log:
        return res.x
    history = make_history(res, mv_per_iter=1.0, mv_initial=1,
                           extra_counters={"mtvps": mtvps})
    history["atol"] = float(atol)
    history["btol"] = float(btol)
    history["ctol"] = float(ctol)
    history["istop"] = int(istop)
    return res.x, history
