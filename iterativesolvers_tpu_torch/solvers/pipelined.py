"""Pipelined (communication-reduced) CG — Ghysels & Vanroose; port of
``iterativesolvers_tpu/solvers/pipelined.py``.

Plain CG on a row-sharded operator pays three allreduces a step (``<c, r>``,
``<u, Au>``, ``|r|``).  The pipelined variant

  * computes its step's three reductions (gamma = <r, u>, delta = <w, u> and
    the lagged |r|) locally, stacks them and reduces them with ONE
    ``mesh.all_reduce`` a step (the JAX package's single psum), and
  * issues the next SpMV (n = A m) before alpha and beta use the reduction,
    so that an asynchronous allreduce (NCCL) runs under the matvec.

Cost: four more vector recurrences (z, q, s, p) than CG, more memory traffic
a step, so on one card plain ``cg`` is usually faster; across ranks the
saved latency counts.  Same convergence as CG in exact arithmetic; the
convergence test reads the residual of the step before (detected one step
late).

Reference: Ghysels & Vanroose, "Hiding global synchronization latency in
the preconditioned Conjugate Gradient algorithm", Parallel Computing 40
(2014).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.dtypes import real_dtype, solve_dtype
from .common import (SolveResult, log_at, make_history, norm, prepare,
                     run_chunked, select, tolerance, with_highest_precision)

__all__ = ["pipelined_cg"]


class PipeCGState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    u: torch.Tensor   # M^{-1} r
    w: torch.Tensor   # A u
    z: torch.Tensor
    q: torch.Tensor
    s: torch.Tensor
    p: torch.Tensor
    gamma: torch.Tensor
    alpha: torch.Tensor
    residual: torch.Tensor
    tol: torch.Tensor
    k: torch.Tensor
    resnorm_log: torch.Tensor


def _pipecg_init(op, b, x0, Pl, reltol, abstol, maxiter, initially_zero):
    dtype = solve_dtype(op.dtype, b.dtype)
    x = x0.to(dtype)
    r = b.to(dtype) if initially_zero else b.to(dtype) - op.mv(x)
    u = Pl.ldiv(r)
    w = op.mv(u)
    residual = norm(r, op.mesh)
    zeros = torch.zeros_like(x)
    one = torch.ones((), dtype=dtype, device=x.device)
    return PipeCGState(
        x=x, r=r, u=u, w=w, z=zeros, q=zeros, s=zeros, p=zeros,
        gamma=one, alpha=one,
        residual=residual,
        tol=tolerance(residual, reltol, abstol),
        k=torch.zeros((), dtype=torch.int64, device=x.device),
        resnorm_log=torch.zeros((max(maxiter, 1),), dtype=real_dtype(dtype),
                                device=x.device),
    )


def _pipecg_step(op, Pl, st: PipeCGState, live=None,
                 log_in_place=False) -> PipeCGState:
    """One pipelined CG step, masked by ``live`` as ``cg``'s steps are."""
    # the step's three reductions, local, in one tensor and one allreduce;
    # the norm is the LAGGED residual |r_k| of the incoming state, so the
    # bundle needs no second reduction after the updates
    red = torch.stack([torch.sum(st.r.conj() * st.u),
                       torch.sum(st.w.conj() * st.u),
                       torch.sum(st.r.conj() * st.r)])
    if op.mesh is not None:
        op.mesh.all_reduce(red)
    # the next SpMV issued before alpha and beta use the reduction
    m = Pl.ldiv(st.w)
    nvec = op.mv(m)
    gamma, delta = red[0], red[1]
    residual = torch.sqrt(red[2].real).to(st.residual.dtype)
    first = st.k == 0
    beta = torch.where(first, 0.0, gamma / st.gamma)
    denom = delta - beta * gamma / st.alpha
    alpha = gamma / torch.where(denom == 0, 1, denom)
    z = nvec + beta * st.z
    q = m + beta * st.q
    s = st.w + beta * st.s
    p = st.u + beta * st.p
    # residual is |r_k| (incoming state): slot k - 1 keeps the series aligned
    # with the other solvers' (slot i = residual after step i + 1); the
    # first step logs nothing
    new = PipeCGState(
        x=st.x + alpha * p, r=st.r - alpha * s, u=st.u - alpha * q,
        w=st.w - alpha * z, z=z, q=q, s=s, p=p,
        gamma=gamma, alpha=alpha,
        residual=residual, tol=st.tol, k=st.k + 1,
        resnorm_log=log_at(st.resnorm_log, st.k - 1, residual,
                           ~first if live is None else live & ~first,
                           log_in_place))
    return select(live, new, st)


@torch.no_grad()
@with_highest_precision
def _pipecg_core(op, b, x0, Pl, reltol, abstol, maxiter, initially_zero,
                 chunk=256):
    state0 = _pipecg_init(op, b, x0, Pl, reltol, abstol, maxiter,
                          initially_zero)
    final = run_chunked(
        lambda st, live: _pipecg_step(op, Pl, st, live, log_in_place=True),
        lambda st: (st.k >= maxiter) | (st.residual <= st.tol),
        state0, chunk=chunk)
    return SolveResult(
        x=final.x,
        iters=final.k,
        converged=final.residual <= final.tol,
        resnorm=final.residual,
        # k steps logged slots 0..k-2 (the first step's lagged norm is not)
        log={"resnorm": (final.resnorm_log, (final.k - 1).clamp(min=0))},
    )


def pipelined_cg(
    A,
    b,
    *,
    x0=None,
    Pl=None,
    abstol: float | None = None,
    reltol: float | None = None,
    maxiter: int | None = None,
    log: bool = False,
    chunk: int = 256,
):
    """Communication-reduced CG for sharded operators: one allreduce a step,
    issued before the step's SpMV.  Same API as ``cg``."""
    p = prepare(A, b, x0, Pl, abstol, reltol, maxiter)
    res = _pipecg_core(p.op, p.b, p.x0, p.Pl, p.reltol, p.abstol, p.maxiter,
                       p.initially_zero, chunk=int(chunk))
    if not log:
        return res.x
    history = make_history(
        res, mv_per_iter=1.0, mv_initial=1 + (0 if p.initially_zero else 1))
    history["abstol"] = float(p.abstol)
    history["reltol"] = float(p.reltol)
    return res.x, history
