"""Spectral-bound helpers for Chebyshev iteration (port of
``iterativesolvers_tpu/utils/spectral.py``).

The reference requires the user to supply ``(lmin, lmax)`` positionally
(src/chebyshev.jl:59,141) and leaves estimation to the user.  These helpers
make the common cases one call:

* :func:`gershgorin_bounds` — rigorous enclosure from diagonal dominance
  (once, on a stencil's terms or a DIA matrix's diagonals).
* :func:`power_bound` — a power-method estimate of ``lambda_max`` on the
  operator's device, with a safety factor, for matrices whose Gershgorin
  radius is too pessimistic.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["gershgorin_bounds", "power_bound"]


def gershgorin_bounds(A) -> tuple[float, float]:
    """Rigorous spectral enclosure [min(d - r), max(d + r)] over the
    Gershgorin discs (real symmetric reading) of a ``StencilOperator``
    (from its terms, as the JAX package) or a ``DIAMatrix`` (from its
    diagonals: the enclosure the JAX package's ``to_csr()`` route gives).
    For Chebyshev the lower bound must be positive — the caller shifts or
    estimates differently otherwise."""
    from ..operators.sparse import DIAMatrix
    from ..operators.stencil import StencilOperator

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
        rows = torch.arange(n, device=A.device)
        d = torch.zeros(n, dtype=torch.float64, device=A.device)
        r = torch.zeros(n, dtype=torch.float64, device=A.device)
        for diag, off in zip(A.diags, A.offsets):
            valid = (rows + off >= 0) & (rows + off < m)
            v = torch.where(valid, diag, 0)
            if off == 0:
                d += (v.real if v.is_complex() else v).double()
            else:
                r += v.abs().double()
        return float((d - r).min()), float((d + r).max())
    raise NotImplementedError(
        f"gershgorin_bounds of a {type(A).__name__}: the port takes a "
        "StencilOperator or a DIAMatrix; the CSR route of the other formats "
        "comes with the sparse formats (ROADMAP.md, Queue A item 6)")


def power_bound(A, iters: int = 30, *, key=None, safety: float = 1.05):
    """Power-method estimate of ``lambda_max(A)`` (symmetric A), scaled by
    ``safety``: ``iters`` + 1 matvecs on the operator's device.  ``key``: a
    ``torch.Generator`` on that device for the start vector (None: seeded
    0)."""
    if key is None:
        key = torch.Generator(device=A.device).manual_seed(0)
    v = torch.randn(A.shape[1], generator=key, dtype=A.dtype,
                    device=key.device)
    v = v / torch.linalg.vector_norm(v)
    with torch.no_grad():
        for _ in range(int(iters)):
            w = A.mv(v)
            v = w / torch.linalg.vector_norm(w)
        lam = torch.sum(v.conj() * A.mv(v)).real
    return lam * safety
