"""Benchmark / test problem generators (port of part of
``iterativesolvers_tpu/utils/fixtures.py``).

  * ``laplace_dia``         ~ test/laplace_matrix.jl:1-13 — dims-D Laplacian
    as a Kronecker sum of the 1-D [-1, 2, -1] stencil, built directly in DIA
    form: offsets {0, ±n^k} with boundary masking.
  * ``sym_tridiagonal_dia`` ~ the CG/MINRES benchmark matrices
    (benchmark/benchmark-linear-systems.jl:24-45,82-88).
  * ``advection_diffusion`` ~ benchmark/advection_diffusion.jl:3-31 — 3-D
    Δu + β·u_x with 2nd-order central differences, Dirichlet boundaries.
  * ``laplace_matrix_coo``  — the ``laplace_dia`` matrix as COO triplets.
  * ``random_sparse``       ~ Julia ``sprand`` as used by the GMRES /
    stationary benchmarks (benchmark/benchmark-linear-systems.jl:47-101).
  * ``variable_diffusion``  — -div(kappa grad u) with a random coefficient
    field.

The arrays are built on the host with numpy, with the JAX package's
formulas and generator calls (so the values agree bit for bit), and moved
to ``device``.
"""

from __future__ import annotations

import numpy as np

from ..operators.sparse import CSRMatrix, DIAMatrix

__all__ = ["laplace_dia", "laplace_matrix_coo", "stencil27_coo",
           "sym_tridiagonal_dia", "advection_diffusion", "random_sparse",
           "variable_diffusion"]


def _laplace_arrays(n: int, dims: int, dtype):
    N = n**dims
    offs = [0] + [n**k for k in range(dims)] + [-(n**k) for k in range(dims)]
    offsets = tuple(sorted(set(offs)))
    data = np.zeros((len(offsets), N), dtype=dtype)
    i = np.arange(N)
    for idx, off in enumerate(offsets):
        if off == 0:
            data[idx] = 2 * dims
        else:
            stride = abs(off)
            pos = (i // stride) % n
            mask = pos < n - 1 if off > 0 else pos > 0
            data[idx] = np.where(mask, -np.ones(N, dtype=dtype), 0)
    return data, offsets, N


def laplace_dia(n: int, dims: int, dtype=np.float64,
                device="cuda") -> DIAMatrix:
    """dims-D Laplacian on an n^dims grid (Kronecker-sum of [-1, 2, -1]).

    Index convention matches the reference's column-major kron order: axis 0
    (x) is the fastest-varying index, so offset n^0 couples along x, n^1 along
    y, etc.
    """
    data, offsets, N = _laplace_arrays(n, dims, dtype)
    return DIAMatrix(data, offsets, (N, N), device=device)


def laplace_matrix_coo(n: int, dims: int, dtype=np.float64):
    """The same dims-D Laplacian as :func:`laplace_dia` in COO triplet form
    (for the MatrixMarket and host-side format-conversion paths).  Returns
    ``(rows, cols, vals, N)``: numpy arrays with 0-based, (row, col)-sorted
    indices, and the order N."""
    csr = laplace_dia(n, dims, dtype=dtype, device="cpu").to_csr()
    return (csr._host("row_ids"), csr._host("indices"), csr._host("data"),
            csr.shape[0])


def stencil27_coo(n: int, center: float = 26.0, dtype=np.float64):
    """The 27-point stencil on an n^3 grid (Dirichlet) in COO triplet form:
    ``center`` on the diagonal and -1 to each of the 26 neighbours, the
    pattern of a hexahedral Q1 mesh (27 diagonals, more than one launch of
    the DIA kernel takes).  Returns ``(rows, cols, vals, N)`` as
    :func:`laplace_matrix_coo` does, in neighbour order."""
    g = np.arange(n, dtype=np.int64)
    i, j, k = (a.ravel() for a in np.meshgrid(g, g, g, indexing="ij"))
    rows, cols = [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                a, b, c = i + di, j + dj, k + dk
                ok = ((a >= 0) & (a < n) & (b >= 0) & (b < n)
                      & (c >= 0) & (c < n))
                rows.append(((i * n + j) * n + k)[ok])
                cols.append(((a * n + b) * n + c)[ok])
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.where(rows == cols, center, -1.0).astype(dtype)
    return rows, cols, vals, n**3


def sym_tridiagonal_dia(diag_val, off_val, n: int, dtype=np.float64,
                        device="cuda") -> DIAMatrix:
    """SymTridiagonal(diag_val, off_val)."""
    data = np.zeros((3, n), dtype=dtype)
    data[0, 1:] = off_val      # offset -1: rows 1..n-1
    data[1, :] = diag_val      # offset 0
    data[2, : n - 1] = off_val  # offset +1: rows 0..n-2
    return DIAMatrix(data, (-1, 0, 1), (n, n), device=device)


def advection_diffusion(N: int = 50, beta: float = 1000.0, dtype=np.float64,
                        device="cuda"):
    """3-D advection-dominated problem Δu + β·u_x = f on (0,1)^3, N^3 interior
    points, central differences.  Returns (A: DIAMatrix, b: ndarray)."""
    n = N**3
    h = 1.0 / (N + 1)
    lap, offsets, _ = _laplace_arrays(N, 3, dtype)
    # A = lap / (-h^2) + ∂x  with ∂x = ±β/(2h) at offsets ±1 along x (fastest).
    data = lap / (-h * h)
    i = np.arange(n)
    posx = i % N
    scale = beta / (2 * h)
    for idx, off in enumerate(offsets):
        if off == 1:
            data[idx] = data[idx] + np.where(posx < N - 1, scale, 0.0)
        elif off == -1:
            data[idx] = data[idx] + np.where(posx > 0, -scale, 0.0)
    A = DIAMatrix(data, offsets, (n, n), device=device)
    xs = np.linspace(0.0, 1.0, N + 2)[1 : N + 1]
    # x fastest, then y, then z (reference column-major comprehension order)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    F = np.exp(X * Y * Z) * np.sin(np.pi * X) * np.sin(np.pi * Y) * np.sin(np.pi * Z)
    b = F.reshape(n, order="F").astype(dtype)
    return A, b


def random_sparse(n: int, m: int, density: float, seed: int = 0,
                  dtype=np.float64, symmetrize: bool = False,
                  shift: float = 0.0, device="cuda") -> CSRMatrix:
    """~ ``sprand(n, m, density)``; with ``symmetrize`` (A + A')/2-style
    structure, plus ``shift * I`` (the GMRES benchmark,
    benchmark/benchmark-linear-systems.jl:47-68)."""
    rng = np.random.default_rng(seed)
    nnz = max(1, int(density * n * m))
    rows = rng.integers(0, n, size=nnz)
    cols = rng.integers(0, m, size=nnz)
    vals = rng.random(nnz).astype(dtype)
    if symmetrize:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
        vals = np.concatenate([vals, vals]) / 2
    if shift:
        d = np.arange(min(n, m))
        rows = np.concatenate([rows, d])
        cols = np.concatenate([cols, d])
        vals = np.concatenate([vals, np.full(d.size, shift, dtype=dtype)])
    return CSRMatrix.from_coo(rows, cols, vals, (n, m), device=device)


def variable_diffusion(n: int, dims: int = 3, contrast: float = 1e4,
                       aniso=None, smooth: int = 0, seed: int = 0,
                       dtype=np.float64, device="cuda") -> DIAMatrix:
    """dims-D finite differences of ``-div(kappa(x) grad u)`` on an n^dims
    grid with a log-uniform random cell coefficient field (the hard-spectrum
    family preconditioners exist for, docs/src/preconditioning.md:5-10).

    * ``contrast``: kappa ranges over [1, contrast) (log-uniform).
    * ``aniso``: per-axis scaling of the face transmissibilities, e.g.
      ``(1, 1, 100)`` for a strongly coupled z-axis.
    * ``smooth``: rounds of separable 3-point box smoothing of the
      log-coefficient field (0 = i.i.d. per cell).

    Face coefficients are harmonic means of the adjacent cells, so the
    matrix is SPD with the unit-step DIA structure of :func:`laplace_dia`
    (axis 0 = offset 1 fastest-varying); Dirichlet boundary faces enter the
    diagonal."""
    N = n**dims
    if aniso is None:
        aniso = (1.0,) * dims
    if len(aniso) != dims:
        raise ValueError(f"aniso needs {dims} entries, got {len(aniso)}")
    rng = np.random.default_rng(seed)
    # numpy shape (n,..,n) with C-order ravel => LAST axis fastest; grid
    # axis k (DIA stride n^k) is numpy axis dims-1-k
    lk = rng.random((n,) * dims)
    for _ in range(smooth):
        for ax in range(dims):
            lk = (np.roll(lk, 1, axis=ax) + lk + np.roll(lk, -1, axis=ax)) / 3
    kappa = np.exp(np.log(contrast) * lk).astype(np.float64)

    offsets = sorted({n**k for k in range(dims)}
                     | {-(n**k) for k in range(dims)} | {0})
    data = {o: np.zeros(N, np.float64) for o in offsets}
    for k in range(dims):
        ax = dims - 1 - k
        s = n**k
        kl = kappa
        kr = np.roll(kappa, -1, axis=ax)  # neighbour at +1 along grid axis k
        t = 2.0 * kl * kr / (kl + kr) * float(aniso[k])
        # zero the face past the boundary (pos == n-1 along this axis)
        hi = [slice(None)] * dims
        hi[ax] = n - 1
        lo = [slice(None)] * dims
        lo[ax] = 0
        t[tuple(hi)] = 0.0
        tf = t.ravel()
        data[s] -= tf                      # A[i, i+s]
        data[-s] -= np.roll(tf, s)         # A[i, i-s] = A[i-s, i]: rolled-in
        # entries land on pos == 0 rows, whose -s column is off the grid
        # and whose tf is the zeroed boundary face
        # diagonal: the interior faces on both sides plus the Dirichlet
        # boundary faces (a ghost cell at the wall, the same kappa)
        bnd = np.zeros_like(t)
        bnd[tuple(hi)] += kappa[tuple(hi)] * float(aniso[k])
        bnd[tuple(lo)] += kappa[tuple(lo)] * float(aniso[k])
        data[0] += tf + np.roll(tf, s) + bnd.ravel()
    arr = np.stack([data[o] for o in offsets]).astype(dtype)
    return DIAMatrix(arr, tuple(offsets), (N, N), device=device)
