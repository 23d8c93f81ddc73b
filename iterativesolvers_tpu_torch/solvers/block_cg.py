"""Multi-RHS (batched) conjugate gradients — port of
``iterativesolvers_tpu/solvers/block_cg.py``.

Solve ``A x_i = b_i`` for all k columns of B at once, with every vector
operation batched over a (k, n) row panel (VECTORS AS ROWS, the block
layout of the package) and the SpMV one ``mv_rows`` of the panel: on the
stencil and DIA operators the CUDA kernel once per row.

This is batched CG (independent Krylov spaces per column, per-column
convergence masking), not classical block CG (shared search space): the
iteration counts match single-RHS CG column for column, which keeps the
semantics of looping ``cg`` over the columns.  A converged column freezes
exactly: its step sizes are 0, so its X, R, residual and rho stay as they
are, with no host read a step.

On a row-sharded operator (``op.mesh``, ``parallel/``) B and X are each
rank's rows and every column reduction (rho, sigma, the residual norms) is
a rank-local sum and one ``mesh.all_reduce`` of its (k,) vector, so the
per-column scalars, and the host's exit, agree on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..operators.linear_operator import as_operator
from ..operators.preconditioners import as_preconditioner
from ..utils.dtypes import real_dtype, solve_dtype
from ..utils.history import ConvergenceHistory
from .common import (SolverIterator, allreduce, log_at, resolve_tols,
                     row_norms, run_chunked, with_highest_precision)

__all__ = ["block_cg", "block_cg_iterator"]


class BlockCGState(NamedTuple):
    X: torch.Tensor          # (k, n) iterates, rows are vectors
    R: torch.Tensor          # (k, n) residuals
    U: torch.Tensor          # (k, n) search directions
    residual: torch.Tensor   # (k,)
    rho: torch.Tensor        # (k,)
    it: torch.Tensor         # scalar iteration counter
    tol: torch.Tensor        # (k,)
    resnorm_log: torch.Tensor  # (maxiter, k)


def _row_dots(A, B, mesh=None):
    """<a_i, b_i> of each row pair, summed over the mesh."""
    return allreduce(torch.sum(A.conj() * B, dim=1), mesh)


def _block_cg_init(op, Br, Xr, reltol, abstol, maxiter):
    dtype = Xr.dtype
    R = Br - op.mv_rows(Xr)
    residual = row_norms(R, op.mesh)
    tol = torch.maximum(reltol * residual, abstol).to(real_dtype(dtype))
    k = Br.shape[0]
    dev = Br.device
    return BlockCGState(
        X=Xr, R=R, U=torch.zeros_like(Xr),
        residual=residual,
        rho=torch.ones((k,), dtype=dtype, device=dev),
        it=torch.zeros((), dtype=torch.int64, device=dev),
        tol=tol,
        resnorm_log=torch.zeros((max(int(maxiter), 1), k),
                                dtype=real_dtype(dtype), device=dev),
    )


def _block_cg_step(op, Pl, s: BlockCGState, maxiter: int, live=None,
                   log_in_place=False) -> BlockCGState:
    """One step; masked by the 0-d bool ``live`` (None: unmasked), where the
    returned state equals ``s``.  Where the solve is done every column is
    past its tolerance or the step count, so alpha and beta are 0 and X, R,
    residual and rho stay as they are: only U, the count and the log need
    the mask."""
    cols = (s.residual > s.tol) & (s.it < maxiter)          # (k,)
    C = Pl.ldiv_rows(s.R)
    rho = _row_dots(C, s.R, op.mesh)
    beta = torch.where(cols, rho / torch.where(s.rho == 0, 1, s.rho), 0)
    U = C + beta[:, None] * s.U
    AU = op.mv_rows(U)
    sigma = _row_dots(U, AU, op.mesh)
    # alpha = 0 freezes converged columns exactly (X, R unchanged)
    alpha = torch.where(cols, rho / torch.where(sigma == 0, 1, sigma), 0)
    X = s.X + alpha[:, None] * U
    R = s.R - alpha[:, None] * AU
    residual = torch.where(cols, row_norms(R, op.mesh), s.residual)
    it = s.it + 1
    if live is not None:
        U = torch.where(live, U, s.U)
        it = s.it + live.to(s.it.dtype)
    return BlockCGState(
        X=X, R=R, U=U,
        residual=residual,
        rho=torch.where(cols, rho, s.rho),
        it=it,
        tol=s.tol,
        resnorm_log=log_at(s.resnorm_log, s.it, residual, live,
                           log_in_place),
    )


def _block_cg_done(s: BlockCGState, maxiter: int):
    return (s.it >= maxiter) | torch.all(s.residual <= s.tol)


def _prepare(A, B, x0, Pl, reltol, abstol, maxiter, solver):
    B = torch.as_tensor(B)
    if B.ndim != 2:
        raise ValueError(f"{solver} expects B of shape (n, k); "
                         "use cg() for a single right-hand side")
    op = as_operator(A, B[:, 0])
    dev = op.device
    B = B.to(dev)
    Pl = as_preconditioner(Pl, device=dev)
    k = B.shape[1]
    # the operator's n (B holds this rank's rows on a mesh)
    maxiter = int(maxiter if maxiter is not None else op.shape[1])
    dtype = solve_dtype(op.dtype, B.dtype)
    Br = B.T.to(dtype).contiguous()              # (k, n) rows
    Xr = (torch.zeros_like(Br) if x0 is None
          else torch.as_tensor(x0, device=dev).T.to(dtype).contiguous())
    reltol_, abstol_ = resolve_tols(dtype, reltol, abstol, device=dev)
    return op, Pl, Br, Xr, reltol_, abstol_, maxiter, k


@torch.no_grad()
@with_highest_precision
def _block_cg_solve(op, Br, Xr, Pl, reltol, abstol, maxiter, chunk=256):
    s0 = _block_cg_init(op, Br, Xr, reltol, abstol, maxiter)
    return run_chunked(
        lambda s, live: _block_cg_step(op, Pl, s, maxiter, live,
                                       log_in_place=True),
        lambda s: _block_cg_done(s, maxiter),
        s0, chunk=chunk)


def block_cg(
    A,
    B,
    *,
    x0=None,
    Pl=None,
    abstol: float | None = None,
    reltol: float | None = None,
    maxiter: int | None = None,
    log: bool = False,
    chunk: int = 256,
):
    """Solve ``A X = B`` for an (n, k) block of right-hand sides with
    batched CG (see module docstring).  Per-column tolerances follow the
    single-RHS ``cg`` contract (``max(reltol * |r0_i|, abstol)``);
    converged columns freeze exactly while the rest continue.

    Returns ``X`` of shape (n, k), or ``(X, history)`` when ``log=True``
    (history.isconverged = all columns; ``history["resnorm"]`` is the
    (iters, k) per-column residual trace).
    """
    op, Pl, Br, Xr, reltol_, abstol_, maxiter, k = _prepare(
        A, B, x0, Pl, reltol, abstol, maxiter, "block_cg")
    final = _block_cg_solve(op, Br, Xr, Pl, reltol_, abstol_, maxiter,
                            chunk=int(chunk))
    X = final.X.T
    if not log:
        return X
    history = ConvergenceHistory(partial=False)
    iters = int(final.it)
    history.iters = iters
    history.isconverged = bool(torch.all(final.residual <= final.tol))
    history.mvps = iters * k + k                 # k per iteration + init
    history["reltol"] = float(reltol_)
    history["abstol"] = float(abstol_)
    history.data["resnorm"] = final.resnorm_log[:iters].cpu().numpy()
    history.data["converged_per_rhs"] = np.asarray(
        (final.residual <= final.tol).cpu())
    return X, history


def block_cg_iterator(
    A,
    B,
    *,
    x0=None,
    Pl=None,
    abstol: float | None = None,
    reltol: float | None = None,
    maxiter: int | None = None,
) -> SolverIterator:
    """Eager block-CG iterator (iterator-protocol uniformity,
    docs/iterators.md): yields the (k,) per-column residual norms each
    iteration; ``.x`` holds the (k, n) row-panel iterate."""
    op, Pl, Br, Xr, reltol_, abstol_, maxiter, _ = _prepare(
        A, B, x0, Pl, reltol, abstol, maxiter, "block_cg_iterator")
    with torch.no_grad():
        state0 = _block_cg_init(op, Br, Xr, reltol_, abstol_, maxiter)

    @torch.no_grad()
    @with_highest_precision
    def step(s):
        return _block_cg_step(op, Pl, s, maxiter)

    return SolverIterator(state0, step=step,
                          done=lambda s: _block_cg_done(s, maxiter),
                          extract=lambda s: s.residual)
