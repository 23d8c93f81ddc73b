"""Preconditioner protocol (port of the first part of
``iterativesolvers_tpu/operators/preconditioners.py``).

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
    "FunctionPreconditioner",
    "as_preconditioner",
    "is_identity",
]


class Preconditioner:
    def ldiv(self, x):
        raise NotImplementedError

    def __call__(self, x):
        return self.ldiv(x)


class IdentityPreconditioner(Preconditioner):
    def ldiv(self, x):
        return x


class DiagonalPreconditioner(Preconditioner):
    """Jacobi preconditioner: P = diag(d); ldiv divides elementwise."""

    def __init__(self, diag, device="cuda"):
        self.diag = torch.as_tensor(diag, device=device)

    def ldiv(self, x):
        return x / self.diag


class FunctionPreconditioner(Preconditioner):
    """Matrix-free preconditioner from a callable x -> P^{-1} x."""

    def __init__(self, ldiv_fn, params=()):
        self._ldiv = ldiv_fn
        self.params = tuple(params)

    def ldiv(self, x):
        return self._ldiv(*self.params, x) if self.params else self._ldiv(x)


def as_preconditioner(P, device="cuda") -> Preconditioner:
    """Coerce ``None`` / a preconditioner / a callable / a 1-D array of the
    diagonal to a :class:`Preconditioner`; a 1-D array goes to ``device``."""
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
        raise NotImplementedError(
            "a dense preconditioner (DensePreconditioner) is not ported yet; "
            "it comes with a later slice of the port")
    raise ValueError(f"cannot interpret preconditioner of type {type(P)}")


def is_identity(P) -> bool:
    return P is None or isinstance(P, IdentityPreconditioner)
