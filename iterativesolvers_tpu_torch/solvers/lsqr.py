"""LSQR — least squares via Golub-Kahan bidiagonalization (port of
``iterativesolvers_tpu/solvers/lsqr.py``).

Paige & Saunders' method, algorithmically CG on the damped normal equations
(src/lsqr.jl:13-19).  The state holds the bidiagonalization vectors (u, v,
w), the rotation scalars and the norm estimators (Anorm / Acond / xnorm /
rnorm / Arnorm, src/lsqr.jl:222-254); a step takes one ``op.mv`` and one
``op.rmv`` (on the stencil, the kernel with ``conj=True``).

istop codes (all computed each iteration; highest-priority last, matching the
reference's overwrite order src/lsqr.jl:256-269):
    7  itn >= maxiter
    6  1 + 1/Acond <= 1         (cond limit at machine precision)
    5  1 + test2  <= 1          (Arnorm test at machine precision)
    4  1 + t1     <= 1          (residual test at machine precision)
    3  1/Acond <= ctol
    2  Arnorm/(Anorm*rnorm) <= atol
    1  rnorm/bnorm <= btol + atol*Anorm*xnorm/bnorm

``isconverged`` is ``istop > 0`` exactly as the reference sets it
(src/lsqr.jl:271: ``setconv(log, istop > 0)``).

On a row-sharded operator (``op.mesh``, ``parallel/``) u lives in the row
space and v, w and x in the column space, each this rank's block of its
own length, and every norm is allreduced over the mesh: the scalars, and
the host's exit, agree on every rank.

Parity note: the reference accumulates ``ddnorm += norm(w/rho)`` *unsquared*
(src/lsqr.jl:207 — a deviation from Paige-Saunders' ``+= norm^2``); it is
kept so Acond estimates match.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..operators.linear_operator import as_operator
from ..utils.dtypes import eps, real_dtype, solve_dtype
from .common import (SolveResult, local_len, log_at, make_history, norm,
                     run_chunked, safe_inv, select, with_highest_precision)

__all__ = ["lsqr"]

_LOGS = ("rnorm_true_log", "test1_log", "test2_log", "test3_log")


class LSQRState(NamedTuple):
    x: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    rhobar: torch.Tensor
    phibar: torch.Tensor
    anorm: torch.Tensor
    ddnorm: torch.Tensor
    res2: torch.Tensor
    xxnorm: torch.Tensor
    z: torch.Tensor
    sn2: torch.Tensor
    cs2: torch.Tensor
    itn: torch.Tensor
    istop: torch.Tensor
    mtvps: torch.Tensor
    bnorm: torch.Tensor
    rnorm_true_log: torch.Tensor   # :resnorm — r1norm (‖b − Ax‖ estimate)
    test1_log: torch.Tensor        # :rnorm  — rnorm/bnorm
    test2_log: torch.Tensor        # :anorm  — Arnorm/(Anorm*rnorm)
    test3_log: torch.Tensor        # :cnorm  — 1/Acond


def _istop(conds):
    """The istop code of ``conds``, a sequence of (condition, code) in the
    order of the reference's assignments: a later true condition wins."""
    istop = torch.zeros((), dtype=torch.int64, device=conds[0][0].device)
    for cond, code in conds:
        istop = torch.where(cond, code, istop)
    return istop


def _lsqr_step(op, damp, atol, btol, ctol, maxiter, s: LSQRState, live=None):
    dampsq = damp * damp
    itn = s.itn + 1

    # bidiagonalization: beta*u = A v - alpha*u ; alpha*v = A'u - beta*v
    u = op.mv(s.v) - s.alpha * s.u
    beta = norm(u, op.mesh)
    bpos = beta > 0
    u = u * safe_inv(beta)
    anorm = torch.where(
        bpos, torch.sqrt(s.anorm**2 + s.alpha**2 + beta**2 + dampsq),
        s.anorm)
    v_new = op.rmv(u) - beta * s.v
    alpha_new = norm(v_new, op.mesh)
    v_new = v_new * safe_inv(alpha_new)
    v = torch.where(bpos, v_new, s.v)
    alpha = torch.where(bpos, alpha_new, s.alpha)
    mtvps = s.mtvps + bpos.to(s.mtvps.dtype)

    # rotation eliminating damp (src/lsqr.jl:180-186)
    rhobar1 = torch.sqrt(s.rhobar**2 + dampsq)
    cs1 = s.rhobar / rhobar1
    sn1 = damp / rhobar1
    psi = sn1 * s.phibar
    phibar = cs1 * s.phibar

    # rotation eliminating the subdiagonal beta (src/lsqr.jl:188-197)
    rho = torch.sqrt(rhobar1**2 + beta**2)
    cs = rhobar1 / rho
    sn = beta / rho
    theta = sn * alpha
    rhobar = -cs * alpha
    phi = cs * phibar
    phibar = sn * phibar
    tau = sn * phi

    # update x, w (src/lsqr.jl:199-207)
    x = s.x + (phi / rho) * s.w
    w = (-theta / rho) * s.w + v
    ddnorm = s.ddnorm + norm(w / rho, op.mesh)  # reference parity: unsquared

    # right rotation for ||x|| estimate (src/lsqr.jl:209-221)
    gambar = -s.cs2 * rho
    rhs = phi - (s.sn2 * rho) * s.z
    zbar = rhs / gambar
    xnorm = torch.sqrt(s.xxnorm + zbar**2)
    gamma = torch.sqrt(gambar**2 + theta**2)
    cs2 = gambar / gamma
    sn2 = theta / gamma
    z = rhs / gamma
    xxnorm = s.xxnorm + z**2

    # norm estimates (src/lsqr.jl:223-254)
    acond = anorm * torch.sqrt(ddnorm)
    res2 = s.res2 + psi**2
    rnorm = torch.sqrt(phibar**2 + res2)
    arnorm = alpha * torch.abs(tau)
    r1sq = rnorm**2 - dampsq * xxnorm
    r1norm = torch.sign(r1sq) * torch.sqrt(torch.abs(r1sq))

    test1 = rnorm / s.bnorm
    test2 = arnorm / (anorm * rnorm)
    test3 = 1.0 / acond
    t1 = test1 / (1 + anorm * xnorm / s.bnorm)
    rtol = btol + atol * anorm * xnorm / s.bnorm

    istop = _istop([(itn >= maxiter, 7), (1 + test3 <= 1, 6),
                    (1 + test2 <= 1, 5), (1 + t1 <= 1, 4),
                    (test3 <= ctol, 3), (test2 <= atol, 2),
                    (test1 <= rtol, 1)])

    k = s.itn
    new = LSQRState(
        x=x, u=u, v=v, w=w, alpha=alpha, beta=beta,
        rhobar=rhobar, phibar=phibar, anorm=anorm, ddnorm=ddnorm,
        res2=res2, xxnorm=xxnorm, z=z, sn2=sn2, cs2=cs2,
        itn=itn, istop=istop, mtvps=mtvps, bnorm=s.bnorm,
        rnorm_true_log=log_at(s.rnorm_true_log, k, r1norm, live, True),
        test1_log=log_at(s.test1_log, k, test1, live, True),
        test2_log=log_at(s.test2_log, k, test2, live, True),
        test3_log=log_at(s.test3_log, k, test3, live, True),
    )
    return select(live, new, s, keep=_LOGS)


def printer(count, fields):
    """``verbose``'s lines (the step number and the logged values of the
    state's ``fields``, as the JAX package prints them from its loop) as a
    ``run_chunked`` ``on_phase`` hook: a phase's lines at its end, the
    steps counted by the state's field ``count``."""
    printed = [0]

    def hook(s):
        k = int(getattr(s, count))
        cols = [getattr(s, f)[printed[0]:k].tolist() for f in fields]
        for i, vals in enumerate(zip(*cols), printed[0]):
            print(f"{i + 1:3d}\t" + "\t".join(f"{v:.2e}" for v in vals))
        printed[0] = max(printed[0], k)

    return hook


@torch.no_grad()
@with_highest_precision
def _lsqr_solve(op, b, x0, damp, atol, btol, ctol, maxiter, verbose):
    dtype = solve_dtype(op.dtype, b.dtype)
    rt = real_dtype(dtype)
    dev = b.device
    x0 = x0.to(dtype)

    u = b.to(dtype) - op.mv(x0)
    beta = norm(u, op.mesh)
    bpos = beta > 0
    u = u * safe_inv(beta)
    v_new = op.rmv(u)
    alpha_new = norm(v_new, op.mesh)
    v = torch.where(bpos, v_new * safe_inv(alpha_new), x0)
    alpha = torch.where(bpos, alpha_new, 0.0)
    arnorm0 = alpha * beta

    L = max(maxiter, 1)

    def zero():
        return torch.zeros((), dtype=rt, device=dev)

    def i64(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    state0 = LSQRState(
        x=x0, u=u, v=v, w=v,
        alpha=alpha, beta=beta,
        rhobar=alpha, phibar=beta,
        anorm=zero(), ddnorm=zero(), res2=zero(), xxnorm=zero(), z=zero(),
        sn2=zero(), cs2=-torch.ones((), dtype=rt, device=dev),
        itn=i64(0), istop=i64(0), mtvps=bpos.to(torch.int64),
        bnorm=beta,
        rnorm_true_log=torch.zeros((L,), dtype=rt, device=dev),
        test1_log=torch.zeros((L,), dtype=rt, device=dev),
        test2_log=torch.zeros((L,), dtype=rt, device=dev),
        test3_log=torch.zeros((L,), dtype=rt, device=dev),
    )

    def done(s):
        # reference: while itn < maxiter & !isconverged; plus the
        # Arnorm == 0 early return (src/lsqr.jl:141-144)
        return ~((s.itn < maxiter) & (s.istop == 0) & (arnorm0 != 0))

    final = run_chunked(
        lambda s, live: _lsqr_step(op, damp, atol, btol, ctol, maxiter, s,
                                   live),
        done, state0,
        on_phase=printer("itn", ("rnorm_true_log", "test2_log", "test3_log",
                                 "test1_log")) if verbose else None)
    return SolveResult(
        x=final.x,
        iters=final.itn,
        converged=final.istop > 0,
        resnorm=final.rnorm_true_log[torch.clamp(final.itn - 1, min=0)],
        log={
            "resnorm": (final.rnorm_true_log, final.itn),
            "rnorm": (final.test1_log, final.itn),
            "anorm": (final.test2_log, final.itn),
            "cnorm": (final.test3_log, final.itn),
        },
    ), final.istop, final.mtvps


def lsqr(
    A,
    b,
    *,
    x0=None,
    damp: float = 0.0,
    atol: float | None = None,
    btol: float | None = None,
    conlim: float | None = None,
    maxiter: int | None = None,
    log: bool = False,
    verbose: bool = False,
):
    """Solve min ‖Ax − b‖² + damp²‖x‖² (~ ``lsqr(!)``, src/lsqr.jl:1-98).

    Defaults follow the reference and scale with the solve dtype
    (src/lsqr.jl:90-93): ``atol = btol = sqrt(eps(real(T)))``,
    ``conlim = 1/sqrt(eps(real(T)))``, ``maxiter = max(m, n)``
    (``maximum(size(A))``) — so float32 operators get attainable
    tolerances and terminate via istop 1-2, not the machine-precision
    guards.  The solve runs on the operator's device; a host ``b`` or
    ``x0`` is moved there.  ``verbose`` prints each step's line, a phase's
    lines at the end of that phase.

    Returns ``x`` or ``(x, ConvergenceHistory)``; the history carries
    ``istop`` and the :resnorm/:rnorm/:anorm/:cnorm series
    (src/lsqr.jl:70-77,240-254).
    """
    op, b, x0, maxiter, dtype, rt = least_squares_setup(A, b, x0, maxiter)
    sqrt_eps = float(np.sqrt(eps(dtype)))
    if atol is None:
        atol = sqrt_eps
    if btol is None:
        btol = sqrt_eps
    if conlim is None:
        conlim = 1.0 / sqrt_eps
    ctol = 1.0 / conlim if conlim > 0 else 0.0

    def t(v):
        return torch.tensor(float(v), dtype=rt, device=b.device)

    res, istop, mtvps = _lsqr_solve(op, b, x0, t(damp), t(atol), t(btol),
                                    t(ctol), maxiter, bool(verbose))
    if not log:
        return res.x
    # the reference counts 1 mvp per iteration and mtvps for the A'u products
    # (src/lsqr.jl:130,152,167); the initial b - A*x is not counted.
    history = make_history(res, mv_per_iter=1.0, mv_initial=0,
                           extra_counters={"mtvps": mtvps})
    history["atol"] = float(atol)
    history["btol"] = float(btol)
    history["ctol"] = float(ctol)
    history["istop"] = int(istop)
    return res.x, history


def least_squares_setup(A, b, x0, maxiter):
    """The common set-up of ``lsqr`` and ``lsmr``: the operator, ``b`` and
    ``x0`` (zeros of the solve dtype when None) on the operator's device,
    ``maxiter`` (``max(m, n)`` when None), the solve dtype and its real
    dtype."""
    op = as_operator(A, b)
    dev = op.device
    b = torch.as_tensor(b, device=dev)
    m, n = op.shape
    maxiter = int(maxiter if maxiter is not None else max(m, n))
    dtype = solve_dtype(op.dtype, b.dtype)
    # x: all n on one device, this rank's block of the columns on a mesh
    x0 = (torch.zeros(local_len(n, op.mesh), dtype=dtype, device=dev)
          if x0 is None else torch.as_tensor(x0, device=dev))
    return op, b, x0, maxiter, dtype, real_dtype(dtype)
