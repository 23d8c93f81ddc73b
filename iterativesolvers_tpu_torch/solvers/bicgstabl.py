"""BiCGStab(l) — port of ``iterativesolvers_tpu/solvers/bicgstabl.py``.

Per cycle an l-step BiCG half (2l SpMVs) followed by an l-dimensional
minimal-residual polynomial step.  The residual and search panels are kept
as (l+1, n) rows, so the MR half is a small Gram matrix, one solve and two
panel products (src/bicgstabl.jl:117-131); ``l`` is a Python int, so the
BiCG half unrolls.

Reference semantics preserved:
  * termination counts **matrix-vector products** (``max_mv_products``),
    not iterations (src/bicgstabl.jl:77, docstring :156-157);
  * the stopping residual is the *preconditioned, recurrence* residual —
    the true residual is never formed (docstring :164-168);
  * the shadow residual is random (src/bicgstabl.jl:38): here drawn by
    ``random_like`` from a ``torch.Generator`` on the operator's device
    seeded with ``seed``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.dtypes import real_dtype, solve_dtype
from .common import (CHUNK, SolveResult, SolverIterator, live_print, log_at,
                     make_history, norm, prepare, random_like, run_chunked,
                     select, tolerance, vdot, with_highest_precision)

__all__ = ["bicgstabl", "bicgstabl_iterator"]


class BiCGStabState(NamedTuple):
    x: torch.Tensor
    rs: torch.Tensor       # (l+1, n)
    us: torch.Tensor       # (l+1, n)
    omega: torch.Tensor
    sigma: torch.Tensor
    mv: torch.Tensor       # mat-vec product count
    residual: torch.Tensor
    tol: torch.Tensor
    k: torch.Tensor        # outer iterations
    resnorm_log: torch.Tensor


def _bicgstabl_init(op, b, x0, Pl, reltol, abstol, l, max_mv,
                    initially_zero):
    dtype = solve_dtype(op.dtype, b.dtype)
    dev = b.device
    x = x0.to(dtype)
    r = b.to(dtype) if initially_zero else b.to(dtype) - op.mv(x)
    r = Pl.ldiv(r)
    nrm = norm(r, op.mesh)
    max_cycles = max(1, (max_mv // (2 * l)) + 2)
    rs = torch.zeros((l + 1, r.shape[0]), dtype=dtype, device=dev)
    rs[0] = r
    one = torch.ones((), dtype=dtype, device=dev)
    return BiCGStabState(
        x=x, rs=rs, us=torch.zeros_like(rs), omega=one, sigma=one,
        mv=torch.full((), 0 if initially_zero else 1, dtype=torch.int64,
                      device=dev),
        residual=nrm,
        tol=tolerance(nrm, reltol, abstol),
        k=torch.zeros((), dtype=torch.int64, device=dev),
        resnorm_log=torch.zeros((max_cycles,), dtype=real_dtype(dtype),
                                device=dev),
    )


def _gram(A, B, mesh):
    """conj(A) @ B^T of two row panels, allreduced over ``mesh``."""
    M = A.conj() @ B.T
    return M if mesh is None else mesh.all_reduce(M)


def _bicgstabl_step(op, Pl, r_shadow, l, s: BiCGStabState, live=None,
                    log_in_place=False) -> BiCGStabState:
    """One l-cycle, masked by ``live`` as ``minres._minres_step``."""
    mesh = op.mesh
    x, rs, us = s.x, s.rs.clone(), s.us.clone()
    sigma = -s.omega * s.sigma
    # BiCG half (src/bicgstabl.jl:88-112), unrolled over j
    for j in range(l):
        rho = vdot(r_shadow, rs[j], mesh)
        beta = rho / sigma
        us[: j + 1] = rs[: j + 1] - beta * us[: j + 1]
        us[j + 1] = Pl.ldiv(op.mv(us[j]))
        sigma = vdot(r_shadow, us[j + 1], mesh)
        alpha = rho / sigma
        rs[: j + 1] -= alpha * us[1: j + 2]
        rs[j + 1] = Pl.ldiv(op.mv(rs[j]))
        x = x + alpha * us[0]

    # MR half (src/bicgstabl.jl:117-131): the (l+1)^2 Gram matrix and a solve
    M = _gram(rs, rs, mesh)
    gamma = torch.linalg.solve(M[1:, 1:], M[1:, 0])
    us[0] = us[0] - gamma @ us[1:]
    x = x + gamma @ rs[:l]
    rs[0] = rs[0] - gamma @ rs[1:]
    residual = norm(rs[0], mesh)
    new = BiCGStabState(
        x=x, rs=rs, us=us, omega=gamma[l - 1], sigma=sigma,
        mv=s.mv + 2 * l, residual=residual, tol=s.tol, k=s.k + 1,
        resnorm_log=log_at(s.resnorm_log, s.k, residual, live, log_in_place))
    return select(live, new, s)


def _bicgstabl_done(s: BiCGStabState, max_mv: int):
    # ~isfinite: an MR-solve or rho/sigma breakdown ends the solve
    # unconverged instead of running NaN cycles to max_mv (NaN compares
    # false on both other clauses)
    return ((s.mv >= max_mv) | (s.residual <= s.tol)
            | ~torch.isfinite(s.residual))


@torch.no_grad()
@with_highest_precision
def _bicgstabl_core(op, b, x0, Pl, r_shadow, reltol, abstol, l, max_mv,
                    initially_zero, verbose=False, chunk=CHUNK):
    """The solve with the shadow residual ``r_shadow`` given (this rank's
    rows on a mesh); returns the SolveResult and the product count."""
    state0 = _bicgstabl_init(op, b, x0, Pl, reltol, abstol, l, max_mv,
                             initially_zero)
    final = run_chunked(
        lambda s, live: _bicgstabl_step(op, Pl, r_shadow, l, s, live,
                                        log_in_place=True),
        lambda s: _bicgstabl_done(s, max_mv), state0, chunk=chunk,
        on_phase=live_print(lambda s: (s.resnorm_log, s.k)) if verbose
        else None)
    return SolveResult(
        x=final.x,
        iters=final.k,
        converged=final.residual <= final.tol,
        resnorm=final.residual,
        log={"resnorm": (final.resnorm_log, final.k)},
    ), final.mv


def _shadow(p, seed):
    """The shadow residual: ``random_like`` of the solve dtype from a
    generator on the operator's device seeded with ``seed``."""
    gen = torch.Generator(device=p.op.device).manual_seed(int(seed))
    return random_like(gen, (p.op.shape[1],),
                       solve_dtype(p.op.dtype, p.b.dtype), p.op.mesh)


def bicgstabl(
    A,
    b,
    l: int = 2,
    *,
    x0=None,
    Pl=None,
    abstol: float | None = None,
    reltol: float | None = None,
    max_mv_products: int | None = None,
    seed: int = 0,
    log: bool = False,
    verbose: bool = False,
    chunk: int = CHUNK,
):
    """Solve A x = b with BiCGStab(l) (~ bicgstabl/bicgstabl!,
    src/bicgstabl.jl:142-219).  ``chunk``: as ``cg``'s, in l-cycles."""
    p = prepare(A, b, x0, Pl, abstol, reltol, max_mv_products)
    res, mv = _bicgstabl_core(p.op, p.b, p.x0, p.Pl, _shadow(p, seed),
                              p.reltol, p.abstol, int(l), p.maxiter,
                              p.initially_zero, verbose=bool(verbose),
                              chunk=int(chunk))
    if not log:
        return res.x
    history = make_history(res, mv_per_iter=0.0, mv_initial=0)
    history.mvps = int(mv)
    history["abstol"] = float(p.abstol)
    history["reltol"] = float(p.reltol)
    return res.x, history


def bicgstabl_iterator(
    A,
    b,
    l: int = 2,
    *,
    x0=None,
    Pl=None,
    abstol: float | None = None,
    reltol: float | None = None,
    max_mv_products: int | None = None,
    seed: int = 0,
) -> SolverIterator:
    """Eager BiCGStab(l) iterator (~ ``bicgstabl_iterator!``,
    src/bicgstabl.jl:55-76): yields the residual norm per l-cycle."""
    p = prepare(A, b, x0, Pl, abstol, reltol, max_mv_products)
    r_shadow = _shadow(p, seed)
    l = int(l)
    with torch.no_grad():
        state0 = _bicgstabl_init(p.op, p.b, p.x0, p.Pl, p.reltol, p.abstol,
                                 l, p.maxiter, p.initially_zero)

    @torch.no_grad()
    @with_highest_precision
    def step(s):
        return _bicgstabl_step(p.op, p.Pl, r_shadow, l, s)

    return SolverIterator(state0, step=step,
                          done=lambda s: _bicgstabl_done(s, p.maxiter),
                          extract=lambda s: s.residual)
