"""LOBPCG — Locally Optimal Block Preconditioned Conjugate Gradient (port of
``iterativesolvers_tpu/solvers/lobpcg.py``).

Solves ``A X = lambda B X`` for the ``nev`` smallest or largest eigenpairs,
blocked, as the JAX package does it:

* All blocks stay full-size; converged columns keep iterating.  A
  numerically dependent direction is zeroed by the masked CholQR
  (:func:`_orthonormalize_masked`), so it decouples exactly from every Gram
  matrix, and the Rayleigh-Ritz step selects only Ritz pairs that live on
  the alive coordinates (:func:`_rayleigh_ritz`).
* The search basis S = [X W P] is B-orthonormalized every iteration (CholQR),
  so the subproblem is a plain ``eigh`` of S'AS on the device.
* The first iteration (span{X, W}) is peeled off the loop; the later ones
  (span{X, W, P}) run in :func:`run_chunked` phases of 8 masked steps, one
  host read after each, waiting (``step_reads_host``: ``eigh`` checks its
  result on the host every step, so the card runs dry there anyway).

Every panel is (k, n) rows (vectors as rows); the SpMVs go through the
operators' ``mv_rows`` (on the stencil and DIA operators the CUDA kernel once
per row); the public API keeps the (n, k) column convention.  Every Gram
matrix and basis transform runs with TF32 off (``with_highest_precision``):
an f32 Gram in TF32 loses the Ritz values.  The Cholesky factor comes from
``torch.linalg.cholesky_ex`` and is NaN where the Gram is not positive
definite, as ``jnp.linalg.cholesky`` returns it, with no exception and no
host read.

Constraints (deflation against given Y, ~ ``Constraint``,
src/lobpcg.jl:144-224) B-project the search directions out of span(Y);
``nev > blocksize`` accumulates converged pairs in an outer host loop
exactly like the reference (src/lobpcg.jl:928-961), each later batch started
from a normal draw of a ``torch.Generator`` seeded 42 on the operator's
device (the JAX package draws from ``PRNGKey(42)``).

On a row-sharded operator (``A.mesh``, ``parallel/``) every panel is this
rank's columns of the (k, n) rows, and every reduction over rows (each
Gram, CholQR's, the projections of the deflation and of P against X, the
unit B-norms and the residual norms) is a rank-local product and one
``mesh.all_reduce``; the update that follows is local.  ``eigh``,
``cholesky_ex`` and the ``alive`` masks then act on replicated values, so
the host's reads (``run_chunked``'s exit, the batch loop's) agree on every
rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..operators.linear_operator import as_operator
from ..operators.preconditioners import as_preconditioner
from ..utils.dtypes import real_dtype
from ..utils.history import ConvergenceHistory
from .common import (SolverIterator, allreduce, log_at, row_norms,
                     run_chunked, select, with_highest_precision)

__all__ = ["lobpcg", "lobpcg_iterator", "LOBPCGResults", "default_tolerance"]


def default_tolerance(dtype) -> float:
    """``eps(real(T))^(3/10)`` (src/lobpcg.jl:751), the power taken in
    ``real(T)`` as the JAX package takes it."""
    eps = np.finfo(torch.empty((), dtype=real_dtype(dtype)).numpy().dtype).eps
    return float(eps ** 0.3)


class LOBPCGResults(NamedTuple):
    """~ ``LOBPCGResults`` (src/lobpcg.jl:36-64)."""

    lam: torch.Tensor             # (nev,) eigenvalues
    X: torch.Tensor               # (n, nev) eigenvectors
    tolerance: float
    residual_norms: torch.Tensor  # (nev,)
    iterations: int               # total across nev>blocksize batches
    maxiter: int
    converged: bool
    history: Optional[ConvergenceHistory] = None
    # per-batch iteration counts, ~ the reference's ``iterations`` vector
    # (one entry per nev>blocksize batch, src/lobpcg.jl:71,86)
    batch_iterations: tuple = ()


# ---------------------------------------------------------------------------
# B-orthonormalization primitives (CholQR, ~ src/lobpcg.jl:341-393)
# ---------------------------------------------------------------------------


def _gram(Vr, Wr, mesh=None):
    """(k, k) Gram G[i, j] = <v_i, w_j> of two row panels (summed over the
    mesh)."""
    return allreduce(Vr.conj() @ Wr.T, mesh)


def _row_bnorms(Vr, BVr, mesh=None):
    """sqrt(max(Re <v_i, Bv_i>, 0)) of each row pair (summed over the
    mesh)."""
    d = allreduce(torch.sum(Vr.conj() * BVr, dim=1), mesh).real
    return torch.sqrt(torch.clamp(d, min=0.0))


def _hermitize(G):
    return 0.5 * (G + G.conj().T)


def _chol_factor(Vr, BVr, mesh=None):
    """Lower Cholesky factor of the (jittered, Hermitized) B-gram V'BV; all
    NaN where the Gram is not positive definite (``jnp.linalg.cholesky``'s
    answer), with no exception and no host read."""
    G = _hermitize(_gram(Vr, BVr, mesh))
    fi = torch.finfo(real_dtype(Vr.dtype))
    jitter = 10.0 * fi.eps * torch.abs(torch.trace(G)) / G.shape[1] + fi.tiny
    G = G + jitter * torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    L, info = torch.linalg.cholesky_ex(G)
    return torch.where(info == 0, L, torch.nan)


def _apply_rinv(R, *mats):
    """Apply the CholQR basis transform V <- V R^{-H} in row layout:
    Vr_new = conj(R)^{-1} Vr.  Because the transform acts on the vectors,
    the A/B images of a block transform the same way — pass them together
    to keep (V, AV, BV) consistent.  The (k, k) inverse comes from one
    lower-triangular solve and each panel takes one matrix product: on an
    H100 ``solve_triangular`` with a (16, 1,030,301) right-hand side took
    8 s (cuBLAS trsm at that n), the product under a millisecond (PERF.md;
    the JAX package solves against each panel, the same values within
    rounding)."""
    Rc = R.conj()
    eye = torch.eye(R.shape[0], dtype=R.dtype, device=R.device)
    Rinv = torch.linalg.solve_triangular(Rc, eye, upper=False)
    out = tuple(Rinv @ M for M in mats)
    return out if len(out) > 1 else out[0]


def _orthonormalize_masked(Vr, BVr, *images, mesh=None):
    """B-orthonormalize (V, BV, images...) by vector-scaled CholQR, zeroing
    vectors that are numerically dependent (the static-shape analogue of the
    reference's dynamic block compression, src/lobpcg.jl:549-562).  All
    panels are (k, n) rows.

    Returns ``(V, BV, *images, alive)`` where ``alive`` is a boolean row
    mask.  Dead rows are exactly zero, so they decouple *exactly* in any
    downstream Gram matrix — no ill-conditioned directions leak into the
    Rayleigh-Ritz basis (critical in f32).
    """
    fi = torch.finfo(real_dtype(Vr.dtype))
    # scale vectors to unit B-norm so the Cholesky diagonal measures
    # independence
    bn = _row_bnorms(Vr, BVr, mesh)
    ref = torch.clamp(torch.max(bn), min=fi.tiny)
    nonzero = bn > (fi.eps * ref)
    scale = torch.where(nonzero, 1.0 / torch.where(nonzero, bn, 1.0), 0.0)
    scale = scale.to(Vr.dtype)[:, None]
    Vr, BVr = Vr * scale, BVr * scale
    images = tuple(M * scale for M in images)
    R = _chol_factor(Vr, BVr, mesh)
    # diag(R) in (0, 1]: sin of the angle to the span of previous vectors
    alive = nonzero & (torch.diagonal(R).real > 10.0 * float(np.sqrt(fi.eps)))
    mask = alive.to(Vr.dtype)[:, None]
    outs = _apply_rinv(R, Vr, BVr, *images)
    return tuple(o * mask for o in outs) + (alive,)


# ---------------------------------------------------------------------------
# Core run
# ---------------------------------------------------------------------------


class _LState(NamedTuple):
    X: torch.Tensor
    AX: torch.Tensor
    BX: torch.Tensor
    P: torch.Tensor
    AP: torch.Tensor
    BP: torch.Tensor
    lam: torch.Tensor
    resnorms: torch.Tensor
    it: torch.Tensor
    resnorm_log: torch.Tensor  # (maxiter, k)


def _rayleigh_ritz(G, k, largest: bool, alive=None):
    """k extremal eigenpairs of the (m, m) Hermitian projected operator
    (~ sub_problem!, src/lobpcg.jl:607-627), on the device.

    ``alive`` marks valid basis coordinates; dead coordinates correspond to
    exactly-zero basis columns, whose (exactly decoupled) spurious zero
    eigenpairs must not be selected.  A Ritz pair is valid iff its eigvec
    weight on alive coordinates exceeds 1/2 (exact split up to degeneracy)."""
    # a Gram with NaNs (a CholQR whose Gram was not positive definite) gives
    # NaN pairs, as jnp.linalg.eigh does; torch's eigh would raise
    bad = torch.isnan(G).any()
    w, C = torch.linalg.eigh(torch.where(bad, 0, G))  # ascending
    w, C = torch.where(bad, torch.nan, w), torch.where(bad, torch.nan, C)
    if alive is not None:
        weight = torch.sum(alive[:, None] * torch.abs(C) ** 2, dim=0)
        big = torch.finfo(w.dtype).max
        w = torch.where(weight > 0.5, w, -big if largest else big)
        order = torch.argsort(-w if largest else w, stable=True)
        idx = order[:k]
        return w[idx], C[:, idx]
    if largest:
        return torch.flip(w, (0,))[:k], torch.flip(C, (1,))[:, :k]
    return w[:k], C[:, :k]


def _bmv(opB, Vr):
    return opB.mv_rows(Vr) if opB is not None else Vr


def _deflate(Yr, BYr, Vr, mesh=None):
    """B-project span(Y) out of the row panel: V - Y (BY^H V) in row layout
    is Vr - (Vr conj(BYr)^T) Yr."""
    if Yr is None:
        return Vr
    return _project_out(Vr, Yr, BYr, mesh)


def _project_out(Vr, Xr, BXr, mesh=None):
    """Vr minus its B-projection onto the rows of Xr (assumed B-orthonormal
    against BXr): V - X (BX^H V) in row layout; the (k, k) coefficients
    summed over the mesh, the update local."""
    return Vr - allreduce(Vr @ BXr.conj().T, mesh) @ Xr


def _ritz_and_split(Sbr, ASbr, BSbr, alive, k, largest, mesh=None):
    """Rayleigh-Ritz on a B-orthonormal (possibly row-masked) basis;
    return new (X, AX, BX) and the B-orthonormalized direction block
    (P, AP, BP) from the W/P coefficients only (~ update_X_P!,
    src/lobpcg.jl:629-690).  All panels (rows = vectors)."""
    G = _hermitize(_gram(Sbr, ASbr, mesh))
    lam, C = _rayleigh_ritz(G, k, largest, alive=alive)
    # column update X = Sb C is the row update Xr = C^T Sbr
    Ct = C.T
    X, AX, BX = Ct @ Sbr, Ct @ ASbr, Ct @ BSbr
    # restore exact unit B-norm (selected pairs can carry a tiny dead-
    # coordinate weight in degenerate clusters)
    xn = _row_bnorms(X, BX, mesh)
    s = torch.where(xn > 0, 1.0 / torch.where(xn > 0, xn, 1.0), 0.0)
    s = s.to(X.dtype)[:, None]
    X, AX, BX = X * s, AX * s, BX * s
    Cpt = C[k:, :].T
    P = Cpt @ Sbr[k:]
    AP = Cpt @ ASbr[k:]
    BP = Cpt @ BSbr[k:]
    P, BP, AP, _ = _orthonormalize_masked(P, BP, AP, mesh=mesh)
    return X, AX, BX, P, AP, BP, lam


def _make_w(opA, opB, prec, Yr, BYr, S, extra_proj=None):
    mesh = opA.mesh
    R_blk = S.AX - S.BX * S.lam[:, None]
    resn = row_norms(R_blk, mesh)
    W = prec.ldiv_rows(R_blk)
    W = _deflate(Yr, BYr, W, mesh)
    W = _project_out(W, S.X, S.BX, mesh)
    if extra_proj is not None:
        Pb, BPb = extra_proj
        W = _project_out(W, Pb, BPb, mesh)
    BW = _bmv(opB, W)
    W, BW, alive_w = _orthonormalize_masked(W, BW, mesh=mesh)
    AW = opA.mv_rows(W)
    return W, AW, BW, alive_w, resn


def _alive(k, dev):
    return torch.ones((k,), dtype=torch.bool, device=dev)


@torch.no_grad()
@with_highest_precision
def _lobpcg_init(opA, opB, prec, Y, BY, X0r, largest, maxiter):
    # all panels (k, n): vectors as rows
    k = X0r.shape[0]
    mesh = opA.mesh
    X = _deflate(Y, BY, X0r, mesh)
    BX = _bmv(opB, X)
    X, BX, _ = _orthonormalize_masked(X, BX, mesh=mesh)
    AX = opA.mv_rows(X)
    lam, C = _rayleigh_ritz(_hermitize(_gram(X, AX, mesh)), k, largest)
    Ct = C.T
    X, AX, BX = Ct @ X, Ct @ AX, Ct @ BX
    rt = real_dtype(X.dtype)
    dev = X.device
    return _LState(
        X=X, AX=AX, BX=BX,
        P=torch.zeros_like(X), AP=torch.zeros_like(X),
        BP=torch.zeros_like(X),
        lam=lam,
        resnorms=torch.full((k,), torch.finfo(rt).max, dtype=rt, device=dev),
        it=torch.zeros((), dtype=torch.int64, device=dev),
        resnorm_log=torch.zeros((max(maxiter, 1), k), dtype=rt, device=dev),
    )


@torch.no_grad()
@with_highest_precision
def _lobpcg_first(opA, opB, prec, Y, BY, S, largest):
    # span{X, W} (src/lobpcg.jl:692-711)
    k = S.X.shape[0]
    W, AW, BW, alive_w, resn = _make_w(opA, opB, prec, Y, BY, S)
    Sb = torch.cat([S.X, W])
    ASb = torch.cat([S.AX, AW])
    BSb = torch.cat([S.BX, BW])
    alive = torch.cat([_alive(k, Sb.device), alive_w])
    X, AX, BX, P, AP, BP, lam = _ritz_and_split(Sb, ASb, BSb, alive, k,
                                                largest, opA.mesh)
    return _LState(
        X=X, AX=AX, BX=BX, P=P, AP=AP, BP=BP, lam=lam, resnorms=resn,
        it=S.it + 1, resnorm_log=log_at(S.resnorm_log, S.it, resn),
    )


@torch.no_grad()
@with_highest_precision
def _lobpcg_main_step(opA, opB, prec, Y, BY, S, largest, live=None,
                      log_in_place=False):
    """span{X, W, P} (src/lobpcg.jl:712-749); masked by the 0-d bool
    ``live`` (None: unmasked), where the returned state equals ``S``.

    P from the previous Ritz step is B-orthonormal but not B-orthogonal to
    the new X (they mix through C), so P is re-orthogonalized against X
    first, its A/B images under the same transforms.  Row layout: the column
    transform P -= X Cxp with Cxp = BX^H P becomes Pr -= Cxp^T Xr with
    Cxp^T = Pr conj(BXr)^T."""
    k = S.X.shape[0]
    mesh = opA.mesh
    Cxpt = allreduce(S.P @ S.BX.conj().T, mesh)
    P = S.P - Cxpt @ S.X
    AP = S.AP - Cxpt @ S.AX
    BP = S.BP - Cxpt @ S.BX
    P, BP, AP, alive_p = _orthonormalize_masked(P, BP, AP, mesh=mesh)
    W, AW, BW, alive_w, resn = _make_w(opA, opB, prec, Y, BY, S,
                                       extra_proj=(P, BP))
    Sb = torch.cat([S.X, W, P])
    ASb = torch.cat([S.AX, AW, AP])
    BSb = torch.cat([S.BX, BW, BP])
    alive = torch.cat([_alive(k, Sb.device), alive_w, alive_p])
    X, AX, BX, Pn, APn, BPn, lam = _ritz_and_split(Sb, ASb, BSb, alive, k,
                                                   largest, mesh)
    new = _LState(
        X=X, AX=AX, BX=BX, P=Pn, AP=APn, BP=BPn, lam=lam, resnorms=resn,
        it=S.it + 1,
        resnorm_log=log_at(S.resnorm_log, S.it, resn, live, log_in_place),
    )
    return select(live, new, S)


def _residual_norms(S, mesh=None):
    return row_norms(S.AX - S.BX * S.lam[:, None], mesh)


def _lobpcg_main(opA, opB, prec, Y, BY, S, tol, largest, maxiter):
    def done(S):
        return ~((S.it < maxiter) & torch.any(S.resnorms > tol))

    S = run_chunked(
        lambda s, live: _lobpcg_main_step(opA, opB, prec, Y, BY, s, largest,
                                          live, log_in_place=True),
        done, S, chunk=8, step_reads_host=True)
    return S, _residual_norms(S, opA.mesh)


def _lobpcg_run(opA, opB, prec, X0r, Y, BY, largest, tol, maxiter):
    S = _lobpcg_init(opA, opB, prec, Y, BY, X0r, largest, maxiter)
    if maxiter >= 1:
        S = _lobpcg_first(opA, opB, prec, Y, BY, S, largest)
    if maxiter >= 2 and bool(torch.any(S.resnorms > tol)):
        return _lobpcg_main(opA, opB, prec, Y, BY, S, tol, largest, maxiter)
    return S, _residual_norms(S, opA.mesh)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


class _Setup(NamedTuple):
    opA: object
    opB: object
    prec: object
    X0: torch.Tensor
    Y: object
    BY: object
    tol: float
    tol_: torch.Tensor


@torch.no_grad()
@with_highest_precision
def _setup(A, X0, B, P, C, tol) -> _Setup:
    opA = as_operator(A)
    dev = opA.device
    X0 = torch.as_tensor(X0, device=dev)
    if X0.ndim != 2:
        raise ValueError("X0 must be (n, blocksize)")
    # the operator's n (X0 holds this rank's rows on a mesh)
    n, bs = opA.shape[0], X0.shape[1]
    if 3 * bs > n:
        raise ValueError("3 * blocksize must be <= n (src/lobpcg.jl:834)")
    opB = as_operator(B, device=dev) if B is not None else None
    prec = as_preconditioner(P, device=dev)
    if tol is None:
        tol = default_tolerance(X0.dtype)
    tol_ = torch.tensor(float(tol), dtype=real_dtype(X0.dtype), device=dev)
    Y = BY = None
    if C is not None:
        Y, BY = _orthonormal_constraint(
            opB, torch.as_tensor(C, device=dev).T.contiguous(), opA.mesh)
    return _Setup(opA, opB, prec, X0, Y, BY, tol, tol_)


@torch.no_grad()
@with_highest_precision
def _orthonormal_constraint(opB, Yr, mesh=None):
    BYr = opB.mv_rows(Yr) if opB is not None else Yr
    Rc = _chol_factor(Yr, BYr, mesh)
    return _apply_rinv(Rc, Yr, BYr)


def lobpcg(
    A,
    X0,
    *,
    B=None,
    largest: bool = False,
    nev: int | None = None,
    P=None,
    C=None,
    tol: float | None = None,
    maxiter: int = 200,
    log: bool = False,
) -> LOBPCGResults:
    """Find the ``nev`` smallest/largest eigenpairs of ``A x = lam B x``.

    Mirrors ``lobpcg(A, [B,] largest, X0, nev; ...)`` (src/lobpcg.jl:799-961):
    ``X0`` is the (n, blocksize) initial block; ``P`` a preconditioner;
    ``C`` an (n, m) basis the iterates stay B-orthogonal to (deflation);
    ``nev > blocksize`` accumulates converged pairs batch-by-batch, adding
    each converged batch to the constraints (src/lobpcg.jl:944-960).
    Requires ``3 * blocksize <= n`` (src/lobpcg.jl:834).  The solve runs on
    ``A``'s device (a host array goes to the card); ``X0``, ``B``, ``P``
    and ``C`` are moved there.
    """
    st = _setup(A, X0, B, P, C, tol)
    X0 = st.X0
    n, bs = st.opA.shape[0], X0.shape[1]
    mesh = st.opA.mesh
    nev = int(nev if nev is not None else bs)
    Y, BY = st.Y, st.BY
    rt = real_dtype(X0.dtype)
    lam_out, X_out, res_out = [], [], []
    batch_iters: list[int] = []
    batch_traces: list[np.ndarray] = []
    converged_all = True
    gen = None
    Xcur = X0.T.contiguous()  # internal layout: vectors as rows (bs, n)
    remaining = nev
    while remaining > 0:
        S, final_resn = _lobpcg_run(st.opA, st.opB, st.prec, Xcur, Y, BY,
                                    largest, st.tol_, maxiter)
        batch_iters.append(int(S.it))
        if log:
            batch_traces.append(
                S.resnorm_log[: int(S.it)].cpu().numpy().max(axis=1))
        take = min(bs, remaining)
        lam_out.append(S.lam[:take])
        X_out.append(S.X[:take])
        res_out.append(final_resn[:take])
        # convergence is judged on the loop's stored residuals, like the
        # reference (src/lobpcg.jl:890) — final_resn is the (slightly
        # different) post-update residual reported to the user
        converged_all &= bool(torch.all(S.resnorms[:take] <= st.tol_))
        remaining -= take
        if remaining > 0:
            newY = S.X[:take]
            Yfull = newY if Y is None else torch.cat([Y, newY])
            Y, BY = _orthonormal_constraint(st.opB, Yfull, mesh)
            if gen is None:
                gen = torch.Generator(device=X0.device).manual_seed(42)
            # the whole draw on every rank, this rank's columns kept
            Xcur = torch.randn((bs, n), generator=gen, dtype=rt,
                               device=X0.device).to(X0.dtype)
            if mesh is not None:
                lo, hi = mesh.rows(n)
                Xcur = Xcur[:, lo:hi].contiguous()

    lam = torch.cat(lam_out)
    X = torch.cat(X_out).T  # back to the (n, nev) public layout
    resn = torch.cat(res_out)

    iterations = int(sum(batch_iters))
    history = None
    if log:
        history = ConvergenceHistory()
        history.iters = iterations
        history.isconverged = converged_all
        # per-iteration max residual norm, every batch's trace concatenated
        # (the reference keeps one trace per nev>blocksize batch,
        # src/lobpcg.jl:74,88; batch boundaries in :batch_iters)
        trace = (np.concatenate(batch_traces) if batch_traces
                 else np.zeros((0,), resn.cpu().numpy().dtype))
        history.set_series("resnorm", trace, trace.size)
        history["batch_iters"] = tuple(batch_iters)
        history["tol"] = float(st.tol)
    return LOBPCGResults(
        lam=lam, X=X, tolerance=float(st.tol), residual_norms=resn,
        iterations=iterations, maxiter=maxiter, converged=converged_all,
        history=history, batch_iterations=tuple(batch_iters),
    )


def lobpcg_iterator(
    A,
    X0,
    *,
    B=None,
    largest: bool = False,
    P=None,
    C=None,
    tol: float | None = None,
    maxiter: int = 200,
):
    """Eager step-wise LOBPCG — the reusable first-class iterator the
    reference exports as ``LOBPCGIterator`` (src/lobpcg.jl:497-522).

    One ``next()`` = one LOBPCG iteration (the first spans {X, W}, later
    ones {X, W, P}, exactly the classic ``lobpcg``'s schedule) and yields
    the max residual norm of the block.  ``.state`` is a checkpoint
    (``.state.lam`` = current Ritz values); ``.x`` is the (n, blocksize)
    eigenvector block in the public column layout.  Covers one block
    (``nev == blocksize``).
    """
    st = _setup(A, X0, B, P, C, tol)
    state0 = _lobpcg_init(st.opA, st.opB, st.prec, st.Y, st.BY,
                          st.X0.T.contiguous(), largest, maxiter)

    def step(S):
        if int(S.it) == 0:
            return _lobpcg_first(st.opA, st.opB, st.prec, st.Y, st.BY, S,
                                 largest)
        return _lobpcg_main_step(st.opA, st.opB, st.prec, st.Y, st.BY, S,
                                 largest)

    def done(S):
        return int(S.it) >= maxiter or bool(torch.all(S.resnorms <= st.tol_))

    return SolverIterator(state0, step, done,
                          extract=lambda S: torch.max(S.resnorms),
                          get_x=lambda S: S.X.T)
