"""Benchmark / test problem generators (port of part of
``iterativesolvers_tpu/utils/fixtures.py``).

  * ``laplace_dia``         ~ test/laplace_matrix.jl:1-13 — dims-D Laplacian
    as a Kronecker sum of the 1-D [-1, 2, -1] stencil, built directly in DIA
    form: offsets {0, ±n^k} with boundary masking.
  * ``sym_tridiagonal_dia`` ~ the CG/MINRES benchmark matrices
    (benchmark/benchmark-linear-systems.jl:24-45,82-88).
  * ``advection_diffusion`` ~ benchmark/advection_diffusion.jl:3-31 — 3-D
    Δu + β·u_x with 2nd-order central differences, Dirichlet boundaries.

The arrays are built on the host with numpy (as in the JAX package, so the
values agree bit for bit) and moved to ``device``.  The CSR fixtures come
with the CSR slice.
"""

from __future__ import annotations

import numpy as np

from ..operators.sparse import DIAMatrix

__all__ = ["laplace_dia", "sym_tridiagonal_dia", "advection_diffusion"]


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
