"""Preconditioner protocol (port of the first part of
``iterativesolvers_tpu/operators/preconditioners.py``: the identity,
diagonal, dense and function preconditioners).

Reference contract (docs/src/preconditioning.md:5-10): a preconditioner must
support ``ldiv!(y, P, x)`` — i.e. apply P^{-1}.  Here the protocol is a single
method ``ldiv(x) -> P^{-1} x`` on tensors.

``IdentityPreconditioner`` mirrors ``Identity`` (src/common.jl:28-32).
"""

from __future__ import annotations

import torch

from .linear_operator import LinearOperator

__all__ = [
    "Preconditioner",
    "IdentityPreconditioner",
    "DiagonalPreconditioner",
    "DensePreconditioner",
    "FunctionPreconditioner",
    "as_preconditioner",
    "is_identity",
]


class Preconditioner:
    def ldiv(self, x):
        raise NotImplementedError

    def ldiv_rows(self, Xr):
        """Apply to a (k, n) ROW panel (vectors as rows, the block solvers'
        layout).  Default: the single-vector apply row by row (the JAX
        package vmaps it); preconditioners with a native block form
        override it."""
        return torch.stack([self.ldiv(r) for r in Xr])

    def __call__(self, x):
        return self.ldiv(x)


class IdentityPreconditioner(Preconditioner):
    def ldiv(self, x):
        return x

    def ldiv_rows(self, Xr):
        return Xr


class DiagonalPreconditioner(Preconditioner):
    """Jacobi preconditioner: P = diag(d); ldiv divides elementwise."""

    def __init__(self, diag, device="cuda"):
        self.diag = torch.as_tensor(diag, device=device)

    def ldiv(self, x):
        return x / self.diag

    def ldiv_rows(self, Xr):
        return Xr / self.diag


class DensePreconditioner(Preconditioner):
    """Dense P, LU-factorized once at construction on ``device``
    (``torch.linalg.lu_factor``); ``ldiv`` is two triangular solves
    (``lu_solve``) in ``promote(P, x)``.  Matches the reference tests' use of
    exact factorizations as preconditioners (test/cg.jl:43-47)."""

    def __init__(self, mat=None, *, lu_and_piv=None, device="cuda"):
        if lu_and_piv is None:
            lu_and_piv = torch.linalg.lu_factor(
                torch.as_tensor(mat, device=device))
        self.lu_and_piv = lu_and_piv

    def ldiv(self, x):
        LU, piv = self.lu_and_piv
        dt = torch.promote_types(LU.dtype, x.dtype)
        b = x.to(dt)
        out = torch.linalg.lu_solve(LU.to(dt), piv,
                                    b[:, None] if b.ndim == 1 else b)
        return out[:, 0] if x.ndim == 1 else out

    def ldiv_rows(self, Xr):
        return self.ldiv(Xr.T).T


class FunctionPreconditioner(Preconditioner):
    """Matrix-free preconditioner from a callable x -> P^{-1} x."""

    def __init__(self, ldiv_fn, params=()):
        self._ldiv = ldiv_fn
        self.params = tuple(params)

    def ldiv(self, x):
        return self._ldiv(*self.params, x) if self.params else self._ldiv(x)


def as_preconditioner(P, device="cuda") -> Preconditioner:
    """Coerce ``None`` / a preconditioner / a callable / a 1-D array of the
    diagonal / a 2-D matrix (LU-factorized, :class:`DensePreconditioner`) to
    a :class:`Preconditioner`; an array goes to ``device``."""
    if P is None:
        return IdentityPreconditioner()
    if isinstance(P, Preconditioner):
        return P
    if callable(P) and not hasattr(P, "ndim") and not isinstance(P, LinearOperator):
        return FunctionPreconditioner(P)
    arr = P if isinstance(P, torch.Tensor) else torch.as_tensor(P)
    if arr.ndim == 1:
        return DiagonalPreconditioner(arr, device=device)
    if arr.ndim == 2:
        return DensePreconditioner(arr, device=device)
    raise ValueError(f"cannot interpret preconditioner of type {type(P)}")


def is_identity(P) -> bool:
    return P is None or isinstance(P, IdentityPreconditioner)
