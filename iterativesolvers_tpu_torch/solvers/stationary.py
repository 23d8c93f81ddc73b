"""Stationary iterative methods: Jacobi, Gauss-Seidel, SOR, SSOR (port of
``iterativesolvers_tpu/solvers/stationary.py``).

Re-design of the reference's ``src/stationary.jl`` (dense) and
``src/stationary_sparse.jl:209-426`` (sparse CSC).  Behavioral contract
(SURVEY §2.3): **exactly maxiter sweeps, no convergence check** (``maxiter=10``
default, src/stationary.jl:22-29); a singular/missing diagonal raises up front
(``check_diag``, src/stationary.jl:6-12; DiagonalIndices,
src/stationary_sparse.jl:18-20).

Sweep algebra (equivalent to the reference's fused column kernels
``forward_sub!(α, F, x, β, y)`` etc., src/stationary_sparse.jl:88-143):

    jacobi:        x <- D^{-1} (b - (A - D) x)
    gauss_seidel:  x <- (D + L)^{-1} (b - U x)
    sor(w):        (D/w + L) x_new = (b - U x) + (1/w - 1) D x
    ssor(w):       forward sor sweep, then the U/L-swapped backward sweep

where L/U are the strict lower/upper triangles.  Dense matrices use
``torch.linalg.solve_triangular`` (with TF32 off, as the JAX package pins the
highest precision); sparse matrices (CSR, or DIA / ELL / HYB through
``to_csr``) use the level-scheduled sweep (ops/triangular.py) — the same
dependency order as the sequential reference loop, parallel across
independent rows.  The split, its diagonal checks and the level schedules
are built once on the host; the sweeps read nothing back to the host.

Dense matrices given as host arrays go to ``device`` (default ``"cuda"``);
a tensor or a sparse operator keeps its own device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import native
from ..operators.preconditioners import sorted_part
from ..operators.sparse import (CSRMatrix, DIAMatrix, ELLMatrix, HYBMatrix,
                                csr_from_dense)
from ..ops.triangular import LevelScheduledTriangular
from ..utils.dtypes import solve_dtype
from .common import SolverIterator, with_highest_precision

__all__ = [
    "jacobi",
    "gauss_seidel",
    "sor",
    "ssor",
    "jacobi_iterable",
    "gauss_seidel_iterable",
    "sor_iterable",
    "ssor_iterable",
    "SingularError",
]

_STORED = (DIAMatrix, ELLMatrix, HYBMatrix)


class SingularError(ValueError):
    """Raised when the matrix diagonal has a missing or zero entry
    (~ ``SingularException``, src/stationary.jl:6-12)."""


# ---------------------------------------------------------------------------
# Host-side matrix splitting
# ---------------------------------------------------------------------------


class _Split(NamedTuple):
    """D/L/U split of A, built once."""

    diag: torch.Tensor                    # (n,)
    lower_mv: Optional[CSRMatrix]         # strict lower triangle (sparse)
    upper_mv: Optional[CSRMatrix]         # strict upper triangle
    lower_solve: Optional[LevelScheduledTriangular]
    upper_solve: Optional[LevelScheduledTriangular]
    dense: Optional[tuple]                # (strict lower, strict upper) dense
    n: int


def _split_matrix(A, need_lower_solve=False, need_upper_solve=False,
                  device="cuda") -> _Split:
    if isinstance(A, _STORED):
        A = A.to_csr()
    if isinstance(A, CSRMatrix):
        n = A.shape[0]
        if A.shape[0] != A.shape[1]:
            raise ValueError("stationary methods need a square matrix")
        # one host copy of the triplets serves the checks, both triangles
        # and their level schedules (a CSR matrix's triplets are row-sorted)
        rows, cols, _ = A._host_coo()
        vals = A.data.cpu()
        on_diag = rows == cols
        present = np.zeros(n, bool)
        present[rows[on_diag]] = True
        d = torch.zeros(n, dtype=vals.dtype)
        d[torch.from_numpy(rows[on_diag])] = vals[torch.from_numpy(on_diag)]
        if not present.all() or bool((d == 0).any()):
            raise SingularError("matrix has a missing or zero diagonal entry")
        parts = {}
        for lower, need in ((True, need_lower_solve),
                            (False, need_upper_solve)):
            mask = (rows > cols) if lower else (rows < cols)
            indptr, indices = sorted_part(rows, cols, mask, n)
            data = vals[torch.from_numpy(mask)]
            op = CSRMatrix(data, indices, indptr, (n, n),
                           row_ids=rows[mask].astype(np.int32),
                           device=A.device)
            solve = None
            if need:
                solve = LevelScheduledTriangular.from_csr(
                    indptr, indices, data, d, lower=lower, device=A.device)
            parts[lower] = (op, solve)
        return _Split(d.to(A.device), parts[True][0], parts[False][0],
                      parts[True][1], parts[False][1], None, n)

    # dense path (src/stationary.jl)
    mat = A if isinstance(A, torch.Tensor) else torch.as_tensor(
        np.asarray(A), device=device)
    if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
        raise ValueError("stationary methods need a square matrix")
    d = torch.diagonal(mat)
    if bool((d == 0).any()):
        raise SingularError("matrix has a zero diagonal entry")
    return _Split(d, None, None, None, None,
                  (torch.tril(mat, -1), torch.triu(mat, 1)),
                  int(mat.shape[0]))


def _mv_strict(split: _Split, which: str, x):
    """(strict L or U) @ x."""
    if split.dense is not None:
        T = split.dense[0] if which == "L" else split.dense[1]
        dt = torch.promote_types(T.dtype, x.dtype)
        return T.to(dt) @ x.to(dt)
    op = split.lower_mv if which == "L" else split.upper_mv
    return op.mv(x)


def _solve_tri(split: _Split, which: str, rhs, omega):
    """Solve (D/omega + T) y = rhs, T the strict lower/upper triangle."""
    if split.dense is not None:
        lower = which == "L"
        T = split.dense[0] if lower else split.dense[1]
        M = T + torch.diag(split.diag if omega is None
                           else split.diag / omega)
        dt = torch.promote_types(M.dtype, rhs.dtype)
        return torch.linalg.solve_triangular(
            M.to(dt), rhs.to(dt)[:, None], upper=not lower)[:, 0]
    solver = split.lower_solve if which == "L" else split.upper_solve
    return solver.solve(rhs, omega=omega)


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------


def _jacobi_sweep(split: _Split, b, x, omega=None):
    # x <- D^{-1} (b - (A - D) x)   (src/stationary.jl:31-49;
    #                                src/stationary_sparse.jl:225-234)
    off = _mv_strict(split, "L", x) + _mv_strict(split, "U", x)
    return (b - off) / split.diag


def _gs_sweep(split: _Split, b, x, omega=None):
    # x <- (D + L)^{-1} (b - U x)   (src/stationary_sparse.jl:278-286)
    return _solve_tri(split, "L", b - _mv_strict(split, "U", x), None)


def _sor_sweep(split: _Split, b, x, omega):
    # (D/w + L) x_new = (b - U x) + (1/w - 1) D x
    # == the reference's gauss_seidel_multiply! + forward_sub!(w, L, ., 1-w, x)
    #    (src/stationary_sparse.jl:322-336)
    rhs = (b - _mv_strict(split, "U", x)) + (1.0 / omega - 1.0) * split.diag * x
    return _solve_tri(split, "L", rhs, omega)


def _backward_sor_sweep(split: _Split, b, x, omega):
    rhs = (b - _mv_strict(split, "L", x)) + (1.0 / omega - 1.0) * split.diag * x
    return _solve_tri(split, "U", rhs, omega)


def _ssor_sweep(split: _Split, b, x, omega):
    # forward SOR then backward SOR (src/stationary.jl:227-263,
    # src/stationary_sparse.jl:392-409)
    return _backward_sor_sweep(split, b, _sor_sweep(split, b, x, omega), omega)


_SWEEPS = {
    "jacobi": _jacobi_sweep,
    "gauss_seidel": _gs_sweep,
    "sor": _sor_sweep,
    "ssor": _ssor_sweep,
}


# ---------------------------------------------------------------------------
# Multicolor sweeps (ordering="multicolor")
#
# Level scheduling keeps the reference's natural update order but is
# depth-bound: on random sparsity the dependency DAG can be O(n) deep.  The
# classical GPU alternative (SURVEY §7 step 6) is greedy multicoloring: rows
# of one color share no edge, so each color class updates fully in parallel —
# a sweep is `ncolors` masked Jacobi-style passes.  The update ORDER differs
# from the natural ordering (documented deviation; the reference itself
# deviates from textbook row order by sweeping CSC column-major,
# docs/src/linear_systems/stationary.md:5-8 — fixed sweep count, not
# ordering, is the contract).
# ---------------------------------------------------------------------------


def _color_classes(A_csr):
    """(color int32 (n,) on the host, ncolors): greedy coloring of the
    symmetrized pattern (the native pass)."""
    n = A_csr.shape[0]
    rows, cols, _ = A_csr._host_coo()
    # the symmetrized pattern's strictly lower part (the lower entries and
    # the upper ones transposed): the greedy pass colors row r from its
    # neighbours j < r only, so this gives the colors of the whole
    # symmetrized pattern (the JAX package's) at half the sort
    lo, up = rows > cols, rows < cols
    rs = np.concatenate([rows[lo], cols[up]])
    cs = np.concatenate([cols[lo], rows[up]])
    indptr, indices, _ = native.coo_to_csr(rs, cs, np.ones(rs.size), n)
    color, nc = native.greedy_coloring(indptr, indices, n)
    return color.astype(np.int32), int(nc)


def _mc_pass(split: _Split, color, c, b, x, omega):
    off = _mv_strict(split, "L", x) + _mv_strict(split, "U", x)
    z = (b - off) / split.diag
    xi = z if omega is None else (1.0 - omega) * x + omega * z
    return torch.where(color == c, xi, x)


def _mc_sweep(method, ncolors, split, color, b, x, omega):
    for c in range(ncolors):
        x = _mc_pass(split, color, c, b, x, omega)
    if method == "ssor":
        for c in range(ncolors - 1, -1, -1):
            x = _mc_pass(split, color, c, b, x, omega)
    return x


@torch.no_grad()
@with_highest_precision
def _run(sweep, maxiter: int, x):
    for _ in range(maxiter):
        x = sweep(x)
    return x


def _prep(A, b, x0, method, ordering="natural", device="cuda"):
    multicolor = ordering == "multicolor" and method != "jacobi"
    need_lo = not multicolor and method in ("gauss_seidel", "sor", "ssor")
    need_up = not multicolor and method == "ssor"
    split = _split_matrix(A, need_lower_solve=need_lo,
                          need_upper_solve=need_up, device=device)
    dev = split.diag.device
    b = torch.as_tensor(b, device=dev)
    dtype = solve_dtype(split.diag.dtype, b.dtype)
    x = (torch.zeros(split.n, dtype=dtype, device=dev) if x0 is None
         else torch.as_tensor(x0, device=dev).to(dtype))
    return split, b, x


def _omega(omega, split):
    if omega is None:
        return None
    return torch.tensor(omega, dtype=split.diag.dtype,
                        device=split.diag.device)


def _solve(A, b, omega, x0, maxiter, method, ordering, device):
    if ordering not in ("natural", "multicolor"):
        raise ValueError("ordering must be 'natural' or 'multicolor'")
    split, b, x = _prep(A, b, x0, method, ordering, device)
    om = _omega(omega, split)
    if ordering == "multicolor" and method != "jacobi":
        if isinstance(A, _STORED):
            Ac = A.to_csr()
        elif isinstance(A, CSRMatrix):
            Ac = A
        else:
            Ac = csr_from_dense(A, device="cpu")
        color, nc = _color_classes(Ac)
        color = torch.from_numpy(color).to(split.diag.device)
        return _run(lambda v: _mc_sweep(method, nc, split, color, b, v, om),
                    int(maxiter), x)
    sweep = _SWEEPS[method]
    return _run(lambda v: sweep(split, b, v, om), int(maxiter), x)


def jacobi(A, b, *, x0=None, maxiter: int = 10, ordering: str = "natural",
           device="cuda"):
    """``maxiter`` Jacobi sweeps (~ ``jacobi(!)``, src/stationary.jl:13-49)."""
    return _solve(A, b, None, x0, maxiter, "jacobi", ordering, device)


def gauss_seidel(A, b, *, x0=None, maxiter: int = 10,
                 ordering: str = "natural", device="cuda"):
    """``maxiter`` Gauss-Seidel sweeps (~ ``gauss_seidel(!)``,
    src/stationary.jl:73-118).  ``ordering='multicolor'`` runs the sweep in
    greedy-coloring order — ncolors parallel passes instead of a
    dependency-depth-bound level schedule (fast path for random sparsity)."""
    return _solve(A, b, None, x0, maxiter, "gauss_seidel", ordering, device)


def sor(A, b, omega: float, *, x0=None, maxiter: int = 10,
        ordering: str = "natural", device="cuda"):
    """``maxiter`` SOR(omega) sweeps (~ ``sor(!)``, src/stationary.jl:131-177)."""
    return _solve(A, b, omega, x0, maxiter, "sor", ordering, device)


def ssor(A, b, omega: float, *, x0=None, maxiter: int = 10,
         ordering: str = "natural", device="cuda"):
    """``maxiter`` symmetric-SOR sweeps — one forward + one backward pass
    per iteration (~ ``ssor(!)``, src/stationary.jl:190-263)."""
    return _solve(A, b, omega, x0, maxiter, "ssor", ordering, device)


# ---------------------------------------------------------------------------
# Iterables (~ jacobi_iterable etc., src/stationary_sparse.jl:236-387)
# ---------------------------------------------------------------------------


class _StationaryState(NamedTuple):
    x: torch.Tensor
    k: torch.Tensor


def _iterable(A, b, method, omega, x0, maxiter, device) -> SolverIterator:
    split, b, x = _prep(A, b, x0, method, device=device)
    sweep = _SWEEPS[method]
    om = _omega(omega, split)

    @torch.no_grad()
    @with_highest_precision
    def step(s: _StationaryState):
        return _StationaryState(sweep(split, b, s.x, om), s.k + 1)

    return SolverIterator(
        _StationaryState(x, torch.zeros((), dtype=torch.int32,
                                        device=x.device)),
        step=step,
        done=lambda s: s.k >= maxiter,
        extract=lambda s: s.x,
    )


def jacobi_iterable(A, b, *, x0=None, maxiter: int = 10, device="cuda"):
    return _iterable(A, b, "jacobi", None, x0, maxiter, device)


def gauss_seidel_iterable(A, b, *, x0=None, maxiter: int = 10,
                          device="cuda"):
    return _iterable(A, b, "gauss_seidel", None, x0, maxiter, device)


def sor_iterable(A, b, omega: float, *, x0=None, maxiter: int = 10,
                 device="cuda"):
    return _iterable(A, b, "sor", omega, x0, maxiter, device)


def ssor_iterable(A, b, omega: float, *, x0=None, maxiter: int = 10,
                  device="cuda"):
    return _iterable(A, b, "ssor", omega, x0, maxiter, device)
