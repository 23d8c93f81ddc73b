"""IDR(s) — Induced Dimension Reduction; port of
``iterativesolvers_tpu/solvers/idrs.py``.

The reference's iterator state is the pair ``(iter, step)`` (src/idrs.jl:163):
steps 1..s build the G_j space one column at a time (each solving a
shrinking lower-triangular system ``M[k:s,k:s] \\ f[k:s]``,
src/idrs.jl:186), step s+1 is the dimension-reduction step with the omega
angle safeguard sqrt(2)/2 (src/idrs.jl:70-81).  Each step takes one SpMV.

As in the JAX package, the shrinking triangular solve is a full s x s solve
on a masked matrix (identity outside the active block, f zero below k),
whose solution has zeros below k and the subsystem's solution from k on.
The JAX package picks the step's kind with a ``lax.cond`` on the device
counter; here the host knows it: the kinds cycle through 0..s in turn, and
only live steps advance the state, so a host counter from the first state's
``step`` (read once) matches every live step, and a masked step's result is
discarded whichever kind it ran.  The shadow space P (s x n) is drawn by
``random_like`` from a ``torch.Generator`` seeded with ``seed`` (reference:
``rand!``, src/idrs.jl:132).

Optional residual ``smoothing`` mirrors src/idrs.jl:119-127,225-234.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.dtypes import real_dtype, solve_dtype
from .common import (SolveResult, SolverIterator, live_print, log_at,
                     make_history, norm, prepare, random_like, run_chunked,
                     select, tolerance, vdot, with_highest_precision)

__all__ = ["idrs", "idrs_iterator"]

_ANGLE = 0.7071067811865476  # sqrt(2)/2 (src/idrs.jl:71)


def _omega(t, s_vec, mesh):
    """Minimal-residual omega with the angle safeguard (src/idrs.jl:70-81)."""
    ns = norm(s_vec, mesh)
    nt = norm(t, mesh)
    ts = vdot(t, s_vec, mesh)
    rho = (ts / (nt * ns)).abs()
    om = ts / (nt * nt)
    return torch.where(rho < _ANGLE,
                       om * _ANGLE / torch.where(rho == 0, 1, rho), om)


class IDRSState(NamedTuple):
    X: torch.Tensor
    R: torch.Tensor
    X_s: torch.Tensor      # smoothing state (unused when smoothing=False)
    R_s: torch.Tensor
    U: torch.Tensor        # (s, n)
    G: torch.Tensor        # (s, n)
    M: torch.Tensor        # (s, s)
    f: torch.Tensor        # (s,)
    omega: torch.Tensor
    normR: torch.Tensor
    tol: torch.Tensor
    it: torch.Tensor       # total steps taken (1 SpMV each)
    step: torch.Tensor     # 0..s-1: G-space build; s: dimension reduction
    resnorm_log: torch.Tensor


def _smooth(Xs, Rs, X, R, mesh):
    """Residual smoothing update (src/idrs.jl:225-234)."""
    Ts = Rs - R
    denom = vdot(Ts, Ts, mesh)
    gamma = vdot(Rs, Ts, mesh) / torch.where(denom == 0, 1, denom)
    Rs = Rs - gamma * Ts
    Xs = Xs - gamma * (Xs - X)
    return Xs, Rs, norm(Rs, mesh)


def _idrs_init(op, b, x0, reltol, abstol, s, maxiter, initially_zero):
    dtype = solve_dtype(op.dtype, b.dtype)
    dev = b.device
    X = x0.to(dtype)
    R = b.to(dtype) if initially_zero else b.to(dtype) - op.mv(X)
    normR = norm(R, op.mesh)
    n = R.shape[0]
    return IDRSState(
        X=X, R=R, X_s=X, R_s=R,
        U=torch.zeros((s, n), dtype=dtype, device=dev),
        G=torch.zeros((s, n), dtype=dtype, device=dev),
        M=torch.eye(s, dtype=dtype, device=dev),
        f=torch.zeros(s, dtype=dtype, device=dev),
        omega=torch.ones((), dtype=dtype, device=dev),
        normR=normR, tol=tolerance(normR, reltol, abstol),
        it=torch.zeros((), dtype=torch.int64, device=dev),
        step=torch.zeros((), dtype=torch.int64, device=dev),
        resnorm_log=torch.zeros((max(maxiter, 1),), dtype=real_dtype(dtype),
                                device=dev),
    )


def _proj(P, v, mesh):
    """conj(P) @ v: the s inner products with the shadow space."""
    out = P.conj() @ v
    return out if mesh is None else mesh.all_reduce(out)


def _k_step(op, Pl, P, k, smoothing, st: IDRSState, live, in_place):
    """Step k < s: the k-th column of the G space (src/idrs.jl:176-222).
    Row k of U and G is written into the state's own panels where
    ``in_place`` (masked by ``live``), else into copies."""
    mesh = op.mesh
    s = P.shape[0]
    f = _proj(P, st.R, mesh) if k == 0 else st.f
    # c = LowerTriangular(M[k:s,k:s]) \ f[k:s], zero below k: M masked to
    # the identity outside the active block, f to zero below k
    idx = torch.arange(s, device=f.device)
    row, col = idx[:, None], idx[None, :]
    eye = (row == col).to(st.M.dtype)
    Mmask = torch.where((row >= k) & (col >= k), st.M, eye)
    fmask = torch.where(idx >= k, f, 0)
    c = torch.linalg.solve_triangular(Mmask, fmask[:, None], upper=False)[:, 0]

    V = Pl.ldiv(st.R - c @ st.G)
    uk = c @ st.U + st.omega * V
    gk = op.mv(uk)
    # bi-orthogonalize against P_i, i < k (src/idrs.jl:206-210)
    for i in range(k):
        alpha = vdot(P[i], gk, mesh) / st.M[i, i]
        gk = gk - alpha * st.G[i]
        uk = uk - alpha * st.U[i]
    # new column M[k:s, k] = P[k:s]' gk (src/idrs.jl:214-216)
    M = st.M.clone()
    M[k:, k] = _proj(P, gk, mesh)[k:]
    beta = f[k] / M[k, k]
    R = st.R - beta * gk
    X = st.X + beta * uk
    normR = norm(R, mesh)
    X_s, R_s = st.X_s, st.R_s
    if smoothing:
        X_s, R_s, normR = _smooth(X_s, R_s, X, R, mesh)
    f = torch.where(idx > k, f - beta * M[:, k], f)
    U, G = (st.U, st.G) if in_place else (st.U.clone(), st.G.clone())
    if live is not None:
        uk, gk = torch.where(live, uk, U[k]), torch.where(live, gk, G[k])
    U[k], G[k] = uk, gk
    return st._replace(X=X, R=R, X_s=X_s, R_s=R_s, U=U, G=G, M=M, f=f,
                       normR=normR, step=st.step + 1)


def _reduction_step(op, Pl, smoothing, st: IDRSState):
    """Step s: the dimension reduction; r is already perpendicular to P, so
    v = r (src/idrs.jl:239-264)."""
    mesh = op.mesh
    V = Pl.ldiv(st.R)
    Q = op.mv(V)
    om = _omega(Q, st.R, mesh)
    R = st.R - om * Q
    X = st.X + om * V
    normR = norm(R, mesh)
    X_s, R_s = st.X_s, st.R_s
    if smoothing:
        X_s, R_s, normR = _smooth(X_s, R_s, X, R, mesh)
    return st._replace(X=X, R=R, X_s=X_s, R_s=R_s, omega=om, normR=normR,
                       step=torch.zeros_like(st.step))


def _idrs_step(op, Pl, P, k, smoothing, st: IDRSState, live=None,
               log_in_place=False) -> IDRSState:
    """The step of kind ``k`` (0..s-1 a column, s the reduction; the host's
    count of ``st.step``), masked by ``live`` as ``minres._minres_step``;
    with ``log_in_place`` (a solve's own loop) it also writes the panels U
    and G in place."""
    if k < P.shape[0]:
        new = _k_step(op, Pl, P, k, smoothing, st, live, log_in_place)
    else:
        new = _reduction_step(op, Pl, smoothing, st)
    new = new._replace(
        it=st.it + 1,
        resnorm_log=log_at(st.resnorm_log, st.it, new.normR, live,
                           log_in_place))
    # in place, a step writes one row of U and G, already masked
    return select(live, new, st, keep=("resnorm_log", "U", "G")
                  if log_in_place else ("resnorm_log",))


def _idrs_done(st: IDRSState, maxiter: int):
    return (st.it >= maxiter) | (st.normR < st.tol)


def _stepper(op, Pl, P, smoothing, state0, log_in_place):
    """``step(state, live)`` with the host's count of the step kind, from
    ``state0.step`` (read once): it advances on every call, which matches
    every live step (live steps come first and advance the state's count
    alike); a masked step's result is discarded."""
    kind = [int(state0.step)]
    s = P.shape[0]

    def step(st, live=None):
        out = _idrs_step(op, Pl, P, kind[0], smoothing, st, live,
                         log_in_place)
        kind[0] = (kind[0] + 1) % (s + 1)
        return out

    return step


@torch.no_grad()
@with_highest_precision
def _idrs_core(op, b, x0, Pl, P, reltol, abstol, s, maxiter, smoothing,
               initially_zero, verbose=False, chunk=256):
    """The solve with the shadow space ``P`` (s, n) given (this rank's
    columns on a mesh)."""
    state0 = _idrs_init(op, b, x0, reltol, abstol, s, maxiter, initially_zero)
    final = run_chunked(
        _stepper(op, Pl, P, smoothing, state0, True),
        lambda st: _idrs_done(st, maxiter), state0, chunk=chunk,
        on_phase=live_print(lambda st: (st.resnorm_log, st.it)) if verbose
        else None)
    return SolveResult(
        x=final.X_s if smoothing else final.X,
        iters=final.it,
        converged=final.normR < final.tol,
        resnorm=final.normR,
        log={"resnorm": (final.resnorm_log, final.it)},
    )


def _shadow(p, s, seed):
    gen = torch.Generator(device=p.op.device).manual_seed(int(seed))
    return random_like(gen, (int(s), p.op.shape[1]),
                       solve_dtype(p.op.dtype, p.b.dtype), p.op.mesh)


def idrs(
    A,
    b,
    *,
    s: int = 8,
    x0=None,
    Pl=None,
    abstol: float | None = None,
    reltol: float | None = None,
    maxiter: int | None = None,
    smoothing: bool = False,
    seed: int = 0,
    log: bool = False,
    verbose: bool = False,
    chunk: int = 256,
):
    """Solve A x = b with IDR(s) (~ idrs/idrs!, src/idrs.jl:11-64).
    ``chunk``: as ``cg``'s."""
    p = prepare(A, b, x0, Pl, abstol, reltol, maxiter)
    res = _idrs_core(p.op, p.b, p.x0, p.Pl, _shadow(p, s, seed), p.reltol,
                     p.abstol, int(s), p.maxiter, bool(smoothing),
                     p.initially_zero, verbose=bool(verbose),
                     chunk=int(chunk))
    if not log:
        return res.x
    history = make_history(res, mv_per_iter=1.0,
                           mv_initial=0 if p.initially_zero else 1)
    history["abstol"] = float(p.abstol)
    history["reltol"] = float(p.reltol)
    return res.x, history


def idrs_iterator(
    A,
    b,
    *,
    s: int = 8,
    x0=None,
    Pl=None,
    abstol: float | None = None,
    reltol: float | None = None,
    maxiter: int | None = None,
    smoothing: bool = False,
    seed: int = 0,
) -> SolverIterator:
    """Eager IDR(s) iterator (~ ``idrs_iterable!``, src/idrs.jl:103-160):
    yields the residual norm each (inner or dimension-reduction) step.  The
    step's kind is read from ``.state.step`` each step, so a replaced state
    resumes where it stands."""
    p = prepare(A, b, x0, Pl, abstol, reltol, maxiter)
    P = _shadow(p, s, seed)
    with torch.no_grad():
        state0 = _idrs_init(p.op, p.b, p.x0, p.reltol, p.abstol, int(s),
                            p.maxiter, p.initially_zero)

    @torch.no_grad()
    @with_highest_precision
    def step(st):
        return _idrs_step(p.op, p.Pl, P, int(st.step), bool(smoothing), st)

    return SolverIterator(
        state0, step=step, done=lambda st: _idrs_done(st, p.maxiter),
        extract=lambda st: st.normR,
        # with smoothing the yielded normR is norm(R_s), so .x must expose
        # the matching smoothed iterate X_s (what _idrs_core returns too)
        get_x=(lambda st: st.X_s) if smoothing else None)
