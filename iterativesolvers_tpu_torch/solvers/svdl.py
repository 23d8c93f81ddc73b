"""svdl — partial SVD via Golub-Kahan-Lanczos with thick restart (port of
``iterativesolvers_tpu/solvers/svdl.py``).

As in the JAX package:

* The Lanczos panels are pre-allocated row panels, ``P`` (k, m) and ``Q``
  (k+1, n) (rows are Lanczos vectors), written in place row by row; stale
  rows are zero, so reorthogonalization against the whole panel is exact.
* The reference's broken-arrow bidiagonal is a small dense (k, k+1) matrix
  ``B``, whose SVD is a k x k device ``torch.linalg.svd``.
* Reorthogonalization is double classical Gram-Schmidt, both passes always,
  on the left and right vectors: two panel products each, with TF32 off.

Macro-iteration (~ svdl_method!, src/svdl.jl:177-247):
    build GKL factorization to k columns
    loop: F = svd(B); convergence check (Wilkinson / Rayleigh-Ritz bounds,
          src/svdl.jl:290-350); thick restart to l columns
          (src/svdl.jl:376-405); extend back to k columns (src/svdl.jl:542-609)

The restart loop runs in :func:`run_chunked` phases of 4 masked
macro-iterations (one host read after each, waiting: ``step_reads_host``,
as ``svd`` checks its result on the host), as the JAX package's.  The harmonic
restart's ``lstsq`` is the minimum-norm solution through the SVD of the
square part of B (the one the convergence check took), as
``jnp.linalg.lstsq`` computes it, so a singular B gives the JAX package's
answer (``torch.linalg.lstsq`` on CUDA assumes full rank).

On a row-sharded operator (``A.mesh``, ``parallel/``) ``P`` holds this
rank's columns of the (k, m) left panel and ``Q`` of the (k+1, n) right
one; the reductions over rows (the reorthogonalization's coefficients, the
Golub-Kahan norms, the start vector's norm) are rank-local sums and one
``mesh.all_reduce`` each, so B, and the ``svd`` / ``qr`` of its small
matrices, are replicated and every rank takes the same exit.  The default
start vector is the whole draw on every rank, each keeping its block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..operators.linear_operator import as_operator
from ..utils.dtypes import real_dtype
from ..utils.history import ConvergenceHistory
from .common import (SolverIterator, allreduce, local_len, log_at, norm,
                     run_chunked, safe_inv, select, with_highest_precision)

__all__ = ["svdl", "svdl_iterator", "PartialFactorization"]


class PartialFactorization(NamedTuple):
    """~ ``PartialFactorization{P,Q,B,beta}`` (src/svdl.jl:76-81), with the
    Lanczos panels stored TRANSPOSED (rows = Lanczos vectors).  In column
    terms: ``A Q[:j] = B[:j, :j]' P`` and ``A' P = B' Q + beta * q_{k+1}
    e_k'``."""

    P: torch.Tensor      # (k, m) left Lanczos panel (rows are vectors)
    Q: torch.Tensor      # (k+1, n) right Lanczos panel (rows are vectors)
    B: torch.Tensor      # (k, k+1): square part + trailing-beta column
    beta: torch.Tensor   # coupling scalar == B[k-1, k]


def _reorth(panel, v, mesh=None):
    """Double classical Gram-Schmidt of v against the ROWS of panel (zeros
    for stale rows), the coefficients summed over the mesh.
    ~ src/svdl.jl:565-577."""
    v = v - allreduce(panel.conj() @ v, mesh) @ panel
    v = v - allreduce(panel.conj() @ v, mesh) @ panel
    return v


def _local_shape(op):
    """The operator's (m, n) rows this rank holds of a left and a right
    vector: (m, n) on one device."""
    m, n = op.shape
    return local_len(m, op.mesh), local_len(n, op.mesh)


def _gkl_extend(op, P, Q, B, j0: int, k: int):
    """Run GKL steps j = j0 .. k-1 (~ extend!, src/svdl.jl:542-609), writing
    rows of P and Q and entries of B in place (the caller's fresh panels).
    Assumes Q rows <= j0, P rows < j0 and B rows/cols < j0 are valid and the
    rest zero.  Returns (P, Q, B, beta)."""
    mesh = op.mesh
    for j in range(j0, k):
        q_j = Q[j]
        # p = A q_j - B[:, j]' P  (B column j carries the arrow after restart)
        p = op.mv(q_j) - B[:, j] @ P
        p = _reorth(P, p, mesh)
        alpha = norm(p, mesh)
        P[j] = p * safe_inv(alpha)
        B[j, j] = alpha
        # r = A' p_j - alpha q_j
        r = op.rmv(P[j]) - alpha * q_j
        r = _reorth(Q, r, mesh)
        beta = norm(r, mesh)
        Q[j + 1] = r * safe_inv(beta)
        B[j, j + 1] = beta
    return P, Q, B, B[k - 1, k]


@torch.no_grad()
@with_highest_precision
def _build(op, v0, k: int) -> PartialFactorization:
    """Bootstrap the factorization from a start vector (~ build,
    src/svdl.jl:353-363)."""
    m, n = _local_shape(op)
    dtype, dev = v0.dtype, v0.device
    P = torch.zeros((k, m), dtype=dtype, device=dev)
    Q = torch.zeros((k + 1, n), dtype=dtype, device=dev)
    Q[0] = v0 / norm(v0, op.mesh)
    B = torch.zeros((k, k + 1), dtype=dtype, device=dev)
    return PartialFactorization(*_gkl_extend(op, P, Q, B, 0, k))


def _restart_core(op, L: PartialFactorization, U, s, V, conv_mask, l: int,
                  k: int, dolock: bool):
    """Thick restart to l columns then extend back to k
    (~ thickrestart! + extend!, src/svdl.jl:376-405,542-609)."""
    m, n = _local_shape(op)
    dtype, dev = L.P.dtype, L.P.device
    Ul = U[:, :l].to(dtype)
    Vl = V[:, :l].to(dtype)
    # row-panel updates: (P Ul)^T = Ul^T P_rows, etc.
    Pn = torch.zeros((k, m), dtype=dtype, device=dev)
    Pn[:l] = Ul.T @ L.P
    Qn = torch.zeros((k + 1, n), dtype=dtype, device=dev)
    Qn[:l] = Vl.T @ L.Q[:k]
    Qn[l] = L.Q[k]
    # arrow: rho_i = beta * U[k-1, i]  (src/svdl.jl:382-390)
    rho = (L.beta * U[k - 1, :l].conj()).to(dtype)
    if dolock:
        # locking zeroes converged arrow entries (src/svdl.jl:215-221)
        rho = torch.where(conv_mask[:l], 0, rho)
    Bn = torch.zeros((k, k + 1), dtype=dtype, device=dev)
    idx = torch.arange(l, device=dev)
    Bn[idx, idx] = s[:l].to(dtype)
    Bn[:l, l] = rho
    return PartialFactorization(*_gkl_extend(op, Pn, Qn, Bn, l, k))


def _min_norm_solve(U, s, V, b):
    """The minimum-norm least-squares solution of ``U diag(s) V^H x = b``
    from a thin SVD, with ``jnp.linalg.lstsq``'s cut-off (singular values
    below ``eps * max(m, n) * s[0]``, and zeros, count as zero)."""
    rcond = torch.finfo(s.dtype).eps * max(U.shape[0], V.shape[0])
    mask = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(mask, 1 / torch.where(mask, s, 1), 0).to(U.dtype)
    return V @ (s_inv[:, None] * (U.conj().T @ b))


def _harmonic_restart_core(op, L: PartialFactorization, U0, s, V0, l: int,
                           k: int):
    """Thick restart with harmonic Ritz values, then extend back to k
    (~ harmonicrestart!, src/svdl.jl:424-494; Baglama & Reichel 2005).

    Real dtypes only (the reference constrains F::SVD{Tr,Tr} likewise).
    ``(U0, s, V0)`` is the SVD of B's square part.  The restarted
    factorization has l+1 complete (P, Q) column pairs and an upper-
    triangular leading block in B; a GKL half-step then produces q_{l+2} so
    the standard extension loop can take over at j0 = l+1.
    """
    m, n = _local_shape(op)
    dtype, dev = L.P.dtype, L.P.device
    beta = L.beta

    rho = beta * U0[k - 1, :]                               # (k,)
    BA = torch.cat([torch.diag(s.to(dtype)), rho[:, None]], dim=1)  # (k, k+1)
    U2, S2, V2t = torch.linalg.svd(BA, full_matrices=True)
    V2 = V2t.T                                              # (k+1, k+1)
    Sig = S2[:l]
    Unew = U0 @ U2[:, :l]                                   # (k, l)

    M = torch.zeros((k + 1, k + 1), dtype=dtype, device=dev)
    M[:k, :k] = V0
    M[k, k] = 1.0
    M = M @ V2                                              # (k+1, k+1)
    Mend = M[k, :l]                                         # (l,)

    e_last = torch.zeros((k, 1), dtype=dtype, device=dev)
    e_last[k - 1] = 1.0
    # scaled residual r = beta * B^{-1} e_k: the minimum-norm solution, the
    # reference's pinv fallback on a singular B (src/svdl.jl:451-459)
    r = _min_norm_solve(U0, s, V0, e_last)[:, 0] * beta
    Mm = M[:k, :] + r[:, None] * M[k:k + 1, :]              # (k, k+1)

    M2 = torch.zeros((k + 1, l + 1), dtype=dtype, device=dev)
    M2[:k, :l] = Mm[:, :l]
    M2[:k, l] = -r
    M2[k, l] = 1.0
    Qf, Rf = torch.linalg.qr(M2, mode="reduced")       # (k+1,l+1), (l+1,l+1)
    Qn = Qf.T @ L.Q                                         # (l+1, n) rows
    Pn = Unew.T @ L.P                                       # (l, m) rows
    R = Rf[:, :l] + Rf[:, l:l + 1] @ Mend[None, :]          # (l+1, l)

    # continue the factorization: f = A q_{l+1} orthogonalized against P
    f = op.mv(Qn[l])
    f = f - allreduce(Pn.conj() @ f, op.mesh) @ Pn
    alpha = norm(f, op.mesh)
    f = f * safe_inv(alpha)

    P = torch.zeros((k, m), dtype=dtype, device=dev)
    P[:l] = Pn
    P[l] = f
    Q = torch.zeros((k + 1, n), dtype=dtype, device=dev)
    Q[:l + 1] = Qn
    B = torch.zeros((k, k + 1), dtype=dtype, device=dev)
    B[:l, :l + 1] = torch.diag(Sig) @ torch.triu(R.T)
    B[l, l] = alpha

    # GKL half-step: q_{l+2} from A'f, then the standard loop at j0 = l+1
    g = _reorth(Q, op.rmv(f), op.mesh)
    beta2 = norm(g, op.mesh)
    Q[l + 1] = g * safe_inv(beta2)
    B[l, l + 1] = beta2
    return PartialFactorization(*_gkl_extend(op, P, Q, B, l + 1, k))


def _ritz_and_bounds_core(L: PartialFactorization):
    """SVD of the projected matrix + error bounds (~ isconverged,
    src/svdl.jl:290-350).  Returns (U, s, V, dsig, delta)."""
    k = L.B.shape[0]
    U, s, Vt = torch.linalg.svd(L.B[:, :k], full_matrices=False)
    V = Vt.conj().T
    dsig = L.beta.abs() * torch.abs(U[-1, :])
    # smallest empirical spectral gap: the smallest |s_i - s_j|, i != j (the
    # JAX package adds eye * inf, which its compiled program takes as inf on
    # the diagonal and 0 elsewhere)
    diff = torch.abs(s[:, None] - s[None, :])
    eye = torch.eye(k, dtype=torch.bool, device=diff.device)
    gap = torch.min(torch.where(eye, torch.inf, diff))
    safe_gap = torch.where(gap > 0, gap, 1)
    refined = torch.minimum(dsig, dsig**2 / safe_gap)
    delta = torch.where((2 * dsig <= gap) & (gap > 0), refined, dsig)
    return U, s, V, dsig, delta


class _SvdlState(NamedTuple):
    L: PartialFactorization
    U: torch.Tensor          # (k, k) left singular vecs of the projected matrix
    s: torch.Tensor          # (k,)
    V: torch.Tensor          # (k, k)
    conv: torch.Tensor       # (k,) per-value convergence at the last check
    converged: torch.Tensor  # bool scalar: leading nsv all converged
    it: torch.Tensor         # macro-iterations completed
    ritz_log: torch.Tensor   # (maxiter, k)
    res_log: torch.Tensor    # (maxiter, k)
    beta_log: torch.Tensor   # (maxiter,)
    conv_log: torch.Tensor   # (maxiter,) bool
    B_log: torch.Tensor      # (maxiter, k, k+1) when log else (1, 1, 1) dummy


_LOGS = ("ritz_log", "res_log", "beta_log", "conv_log", "B_log")


def _svdl_step(op, tol, reltol, nsv: int, j: int, k: int, dolock: bool,
               method: str, log: bool, S: _SvdlState, live=None,
               log_in_place=False) -> _SvdlState:
    """One macro-iteration: Ritz + bounds + convergence log + thick restart
    (the body of the reference's host loop, src/svdl.jl:188-226); masked
    by the 0-d bool ``live`` (None: unmasked), where the returned state
    equals ``S``.  Shared by ``svdl``'s loop and ``svdl_iterator``."""
    rt = S.s.dtype
    U, s, V, dsig, delta = _ritz_and_bounds_core(S.L)
    thresh = torch.maximum(tol, reltol * s[0])
    conv = delta < thresh
    all_conv = torch.all(conv[:nsv])

    def logged(buf, value):
        return log_at(buf, S.it, value, live, log_in_place)

    ritz_log = logged(S.ritz_log, s)
    res_log = logged(S.res_log, delta)
    beta_log = logged(S.beta_log, torch.abs(S.L.beta).to(rt))
    conv_log = logged(S.conv_log, all_conv)
    B_log = logged(S.B_log, S.L.B) if log else S.B_log
    if method == "harmonic":
        L_new = _harmonic_restart_core(op, S.L, U, s, V, j, k)
    else:
        L_new = _restart_core(op, S.L, U, s, V, conv, j, k, dolock)
    # on the converging iteration the reference breaks before restarting
    L_out = PartialFactorization(*(torch.where(all_conv, a, b)
                                   for a, b in zip(S.L, L_new)))
    new = _SvdlState(
        L=L_out, U=U, s=s, V=V, conv=conv, converged=all_conv,
        it=S.it + 1, ritz_log=ritz_log, res_log=res_log,
        beta_log=beta_log, conv_log=conv_log, B_log=B_log,
    )
    if live is None:
        return new
    L_keep = PartialFactorization(*(torch.where(live, a, b)
                                    for a, b in zip(new.L, S.L)))
    out = select(live, new._replace(L=None), S._replace(L=None),
                 keep=_LOGS + ("L",))
    return out._replace(L=L_keep)


def _svdl_state0(L0, maxiter: int, log: bool) -> _SvdlState:
    dtype, dev = L0.P.dtype, L0.P.device
    rt = real_dtype(dtype)
    mi = max(maxiter, 1)
    k_ = L0.B.shape[0]

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    return _SvdlState(
        L=L0,
        U=zeros((k_, k_), dtype),
        s=zeros((k_,), rt),
        V=zeros((k_, k_), dtype),
        conv=zeros((k_,), torch.bool),
        converged=zeros((), torch.bool),
        it=zeros((), torch.int64),
        ritz_log=zeros((mi, k_), rt),
        res_log=zeros((mi, k_), rt),
        beta_log=zeros((mi,), rt),
        conv_log=zeros((mi,), torch.bool),
        B_log=(zeros((mi, k_, k_ + 1), L0.B.dtype) if log
               else zeros((1, 1, 1), L0.B.dtype)),
    )


@torch.no_grad()
@with_highest_precision
def _svdl_run(op, L0, tol, reltol, nsv: int, j: int, k: int, dolock: bool,
              method: str, maxiter: int, log: bool):
    """The restart loop (~ the reference's host loop src/svdl.jl:188-226),
    in phases of 4 masked macro-iterations."""
    def step(S, live):
        return _svdl_step(op, tol, reltol, nsv, j, k, dolock, method, log, S,
                          live, log_in_place=True)

    def done(S: _SvdlState):
        return S.converged | (S.it >= maxiter)

    return run_chunked(step, done, _svdl_state0(L0, maxiter, log), chunk=4,
                       step_reads_host=True)


class _Setup(NamedTuple):
    op: object
    l: int
    k: int
    j: int
    maxiter: int
    tol: float
    reltol: float
    v0: torch.Tensor


def _setup(A, nsv, k, j, v0, tol, reltol, maxiter, method, key):
    if method not in ("ritz", "harmonic"):
        raise ValueError(f"unknown restart method {method!r}")
    op = as_operator(A)
    if method == "harmonic" and op.dtype.is_complex:
        raise ValueError(
            "harmonic restart supports real operators only "
            "(the reference constrains F::SVD{Tr,Tr}, src/svdl.jl:425-426)")
    m, n = op.shape
    l = int(nsv)
    k = int(k if k is not None else 2 * l)
    j = int(j if j is not None else l)
    if k <= 1:
        raise ValueError("k must be > 1 (src/svdl.jl:184)")
    if k > min(m, n):
        raise ValueError("k must be <= min(size(A))")
    maxiter = int(maxiter if maxiter is not None else min(m, n))
    rt = real_dtype(op.dtype)
    if tol is None:
        tol = float(np.sqrt(torch.finfo(rt).eps))
    if reltol is None:
        reltol = float(np.sqrt(torch.finfo(rt).eps))
    dev = op.device
    if v0 is None:
        if key is None:
            key = torch.Generator(device=dev).manual_seed(0)
        v0 = torch.randn(n, generator=key, dtype=rt,
                         device=key.device).to(op.dtype)
        if op.mesh is not None:
            lo, hi = op.mesh.rows(n)
            v0 = v0[lo:hi]
    # a given v0 is this rank's block on a mesh, as b is for the solvers
    v0 = torch.as_tensor(v0, device=dev)
    return _Setup(op, l, k, j, maxiter, tol, reltol, v0)


def svdl(
    A,
    *,
    nsv: int = 6,
    k: Optional[int] = None,
    j: Optional[int] = None,
    v0=None,
    tol: float | None = None,
    reltol: float | None = None,
    maxiter: Optional[int] = None,
    method: str = "ritz",
    vecs: str = "none",
    dolock: bool = False,
    log: bool = False,
    key=None,
):
    """Largest ``nsv`` singular values (optionally vectors) of ``A``.

    Mirrors ``svdl`` (src/svdl.jl:157-171): ``k = 2*nsv`` subspace columns,
    restart rank ``j = nsv``, ``tol = reltol = sqrt(eps)``, ``maxiter =
    min(m, n)``, ``vecs in ('none', 'left', 'right', 'both')``.

    ``method='ritz'`` is the thick restart of Wu & Simon; ``'harmonic'``
    restarts with harmonic Ritz values (Baglama & Reichel,
    src/svdl.jl:424-494; real operators only).  The start vector is ``v0``,
    else a normal draw from ``key``, a ``torch.Generator`` (None: seeded 0
    on the operator's device); the JAX package draws from a ``jax.random``
    key.

    Returns ``(values, fact)`` for ``vecs='none'``, else
    ``((leftvecs, values, rightvecs_T), fact)``; append history when
    ``log=True``.
    """
    st = _setup(A, nsv, k, j, v0, tol, reltol, maxiter, method, key)
    op, l, k, j = st.op, st.l, st.k, st.j
    rt = real_dtype(op.dtype)
    dev = op.device
    L = _build(op, st.v0, k)
    S = _svdl_run(op, L,
                  torch.tensor(st.tol, dtype=rt, device=dev),
                  torch.tensor(st.reltol, dtype=rt, device=dev),
                  l, j, k, dolock, method, st.maxiter, log)
    L, U, s, V = S.L, S.U, S.s, S.V
    iters = int(S.it)
    converged = bool(S.converged)

    values = s[:l]
    history = None
    if log:
        history = ConvergenceHistory(partial=not log)
        history.iters = iters
        history.isconverged = converged
        history["tol"] = st.tol
        history.data["ritz"] = S.ritz_log[:iters].cpu().numpy()
        history.data["resnorm"] = S.res_log[:iters].cpu().numpy()
        history.data["betas"] = S.beta_log[:iters].cpu().numpy()
        history.data["conv"] = S.conv_log[:iters].cpu().numpy()
        history.data["Bs"] = S.B_log[:iters].cpu().numpy()
        history.mvps = iters * (k - j) + k
        history.mtvps = iters * (k - j) + k

    if vecs == "none":
        out = (values, L)
    else:
        left, right = _vectors(U, V, L, l, k, vecs)
        out = ((left, values, right), L)
    if log:
        return (*out, history)
    return out


@torch.no_grad()
@with_highest_precision
def _vectors(U, V, L, l, k, vecs):
    """``(leftvecs, rightvecs_T)`` of ``svdl``'s ``vecs`` (None where not
    asked)."""
    left = (U[:, :l].T @ L.P).T if vecs in ("left", "both") else None
    right = ((V[:, :l].T @ L.Q[:k]).conj().resolve_conj()
             if vecs in ("right", "both") else None)
    return left, right


def svdl_iterator(
    A,
    *,
    nsv: int = 6,
    k: Optional[int] = None,
    j: Optional[int] = None,
    v0=None,
    tol: float | None = None,
    reltol: float | None = None,
    maxiter: Optional[int] = None,
    method: str = "ritz",
    dolock: bool = False,
    key=None,
):
    """Eager macro-iteration stepper over svdl's restart loop (one
    ``next()`` = one Ritz + convergence check + thick restart, ~ one trip of
    the host loop src/svdl.jl:188-226).

    Yields the leading-``nsv`` max error bound after each macro-iteration;
    ``.state`` is a checkpoint (``.state.s`` = current Ritz values,
    ``.state.L`` = the partial factorization); ``.x`` is the current
    ``nsv`` singular-value estimate vector.
    """
    st = _setup(A, nsv, k, j, v0, tol, reltol, maxiter, method, key)
    op, l, k, j = st.op, st.l, st.k, st.j
    rt = real_dtype(op.dtype)
    dev = op.device
    state0 = _svdl_state0(_build(op, st.v0, k), st.maxiter, log=True)
    tol_ = torch.tensor(st.tol, dtype=rt, device=dev)
    reltol_ = torch.tensor(st.reltol, dtype=rt, device=dev)

    @torch.no_grad()
    @with_highest_precision
    def step(S):
        return _svdl_step(op, tol_, reltol_, l, j, k, dolock, method, True, S)

    def done(S):
        return bool(S.converged) or int(S.it) >= st.maxiter

    return SolverIterator(
        state0, step, done,
        extract=lambda S: torch.max(S.res_log[S.it - 1, :l]),
        get_x=lambda S: S.s[:l])
