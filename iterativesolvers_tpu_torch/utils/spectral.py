"""Spectral-bound helpers for Chebyshev iteration (port of
``iterativesolvers_tpu/utils/spectral.py``).

The reference requires the user to supply ``(lmin, lmax)`` positionally
(src/chebyshev.jl:59,141) and leaves estimation to the user.  These helpers
make the common cases one call:

* :func:`gershgorin_bounds` — rigorous enclosure from diagonal dominance
  (once, on a stencil's terms, a DIA matrix's diagonals or a CSR form).
* :func:`power_bound` — a power-method estimate of ``lambda_max`` on the
  operator's device, with a safety factor, for matrices whose Gershgorin
  radius is too pessimistic.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["gershgorin_bounds", "power_bound"]


def _reduced_bounds(lo, hi, mesh):
    """(min, max) of this rank's ``lo`` / ``hi`` (0-d tensors) over the
    mesh: one all-reduce of ``(-lo, hi)`` by max, so every rank holds the
    one-device bits."""
    t = torch.stack([-lo, hi])
    if mesh is not None:
        mesh.all_reduce(t, op="max")
    return float(-t[0]), float(t[1])


def gershgorin_bounds(A) -> tuple[float, float]:
    """Rigorous spectral enclosure [min(d - r), max(d + r)] over the
    Gershgorin discs (real symmetric reading) of a ``StencilOperator``
    (from its terms, as the JAX package), a ``DIAMatrix`` (from its
    diagonals: the enclosure the JAX package's ``to_csr()`` route gives) or
    any operator with a CSR form (``CSRMatrix``, or ``to_csr()``: ELL, HYB,
    ``GradientOperator``), on the host.  A row-sharded DIA or ELL matrix
    (``parallel/sharded.py``) takes this rank's rows and one all-reduce of
    the two bounds: every rank gets one device's bits.  For Chebyshev the
    lower bound must be positive — the caller shifts or estimates
    differently otherwise."""
    from ..operators.sparse import CSRMatrix, DIAMatrix, ELLMatrix
    from ..operators.stencil import StencilOperator

    mesh = getattr(A, "mesh", None)
    if isinstance(A, StencilOperator):
        i = np.arange(A.n)
        d = np.full(A.n, float(np.real(A.center)))
        r = np.zeros(A.n)
        for (o, s, e), c in zip(A.terms, A.coeffs):
            pos = (i // s) % e
            step = o // s
            valid = (pos + step >= 0) & (pos + step < e)
            r += np.where(valid, abs(c), 0.0)
        return float((d - r).min()), float((d + r).max())
    if isinstance(A, DIAMatrix):
        n, m = A.shape
        lo = getattr(A, "row_lo", 0)
        rows = torch.arange(lo, lo + A.diags[0].shape[0], device=A.device)
        d = torch.zeros(rows.shape[0], dtype=torch.float64, device=A.device)
        r = torch.zeros_like(d)
        for diag, off in zip(A.diags, A.offsets):
            valid = (rows + off >= 0) & (rows + off < m)
            v = torch.where(valid, diag, 0)
            if off == 0:
                d += (v.real if v.is_complex() else v).double()
            else:
                r += v.abs().double()
        return _reduced_bounds((d - r).min(), (d + r).max(), mesh)
    if not (isinstance(A, CSRMatrix) or hasattr(A, "to_csr")):
        raise TypeError(
            f"gershgorin_bounds of a {type(A).__name__}: it takes a "
            "StencilOperator, a DIAMatrix or an operator with a CSR form")
    lo = 0
    if mesh is not None and isinstance(A, ELLMatrix):
        # this rank's rows of a row-sharded ELL matrix
        csr, lo = A.local.to_csr(), mesh.rows(A.shape[0])[0]
    else:
        csr, mesh = (A if isinstance(A, CSRMatrix) else A.to_csr()), None
    rows, cols, vals = csr._host_coo()
    n = csr.shape[0]
    d = np.zeros(n, np.float64)
    diag_mask = rows + lo == cols
    d[rows[diag_mask]] = vals[diag_mask].real
    r = np.zeros(n, np.float64)
    off = ~diag_mask
    np.add.at(r, rows[off], np.abs(vals[off]))
    return _reduced_bounds(torch.from_numpy(d - r).min(),
                           torch.from_numpy(d + r).max(), mesh)


def power_bound(A, iters: int = 30, *, key=None, safety: float = 1.05):
    """Power-method estimate of ``lambda_max(A)`` (symmetric A), scaled by
    ``safety``: ``iters`` + 1 matvecs on the operator's device.  ``key``: a
    ``torch.Generator`` on that device for the start vector (None: seeded
    0).  On a mesh operator the start vector is drawn whole, every rank
    keeping its rows, and the norms and the Rayleigh quotient are reduced
    over ``A.mesh``: one device's estimate on the same generator."""
    from ..solvers.common import allreduce, norm

    mesh = getattr(A, "mesh", None)
    if key is None:
        key = torch.Generator(device=A.device).manual_seed(0)
    v = torch.randn(A.shape[1], generator=key, dtype=A.dtype,
                    device=key.device)
    if mesh is not None:
        lo, hi = mesh.rows(A.shape[1])
        v = v[lo:hi].to(A.device)
    v = v / norm(v, mesh)
    with torch.no_grad():
        for _ in range(int(iters)):
            w = A.mv(v)
            v = w / norm(w, mesh)
        lam = allreduce(torch.sum(v.conj() * A.mv(v)), mesh).real
    return lam * safety
