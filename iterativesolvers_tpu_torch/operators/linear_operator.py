"""Linear operator protocol (port of
``iterativesolvers_tpu/operators/linear_operator.py``).

The reference's operator contract is duck-typed Julia: ``A*v``, ``mul!(y,A,v)``,
``adjoint(A)``, ``eltype``, ``size`` (docs/src/getting_started.md:22-31).  Here
an operator is an object with ``shape``, ``dtype``, ``device`` and
``mv``/``rmv`` methods on tensors.  Matrix-free operators (reference tests use
LinearMaps.jl, e.g. test/cg.jl:71-77) are ``FunctionOperator``s.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..utils.dtypes import as_dtype

__all__ = [
    "LinearOperator",
    "MatrixOperator",
    "FunctionOperator",
    "AdjointOperator",
    "ScaledIdentityPlusOperator",
    "as_operator",
]


class LinearOperator:
    """Abstract operator: knows ``shape``, ``dtype``, ``device``, ``mv`` and
    (optionally) ``rmv``."""

    shape: Tuple[int, int]
    device: torch.device
    # the mesh of a row-sharded operator (parallel/sharded.py), whose
    # vectors are each rank's block of rows; None on one device
    mesh = None

    @property
    def dtype(self):
        raise NotImplementedError

    def mv(self, x):
        """y = A @ x"""
        raise NotImplementedError

    def rmv(self, x):
        """y = A^H @ x (adjoint matvec). Solvers needing it: QMR/LSQR/LSMR/svdl."""
        raise NotImplementedError(
            f"{type(self).__name__} does not provide an adjoint matvec"
        )

    def mv_dot(self, x):
        """(A x, <x, A x>) — the SpMV + first CG reduction (src/cg.jl:54-55)
        as one bundle so operators with a fused kernel can produce both in a
        single pass over device memory."""
        y = self.mv(x)
        return y, torch.sum(x.conj() * y)

    def mv_rows(self, Xr):
        """Row-panel product: ``Xr`` is (k, n) with VECTORS AS ROWS; returns
        the (k, m) row panel of ``A @ x`` per row.  Block solvers (LOBPCG,
        block CG) keep panels in this layout.  The default transposes
        through ``mv`` of the (n, k) columns; concrete formats override it
        with a product that keeps the rows."""
        return self.mv(Xr.T).T

    # Conveniences mirroring the Julia surface.
    def __matmul__(self, x):
        return self.mv(x)

    @property
    def H(self) -> "LinearOperator":
        return AdjointOperator(self)

    @property
    def T(self) -> "LinearOperator":
        # For real operators T == H; complex users should use .H explicitly.
        return AdjointOperator(self)

    def to_dense(self):
        n, m = self.shape
        eye = torch.eye(m, dtype=self.dtype, device=self.device)
        return torch.stack([self.mv(eye[:, j]) for j in range(m)], dim=1)


class MatrixOperator(LinearOperator):
    """Dense matrix operator (``torch.matmul``)."""

    def __init__(self, mat):
        self.mat = mat

    @property
    def shape(self):
        return tuple(self.mat.shape)

    @property
    def dtype(self):
        return self.mat.dtype

    @property
    def device(self):
        return self.mat.device

    def mv(self, x):
        return self.mat @ x

    def rmv(self, x):
        return self.mat.conj().T @ x

    def mv_rows(self, Xr):
        # (A X)^T = X^T A^T: one GEMM, the minor dim stays n
        return Xr @ self.mat.T

    def to_dense(self):
        return self.mat


class FunctionOperator(LinearOperator):
    """Matrix-free operator from callables on tensors.  ``params`` are
    passed before ``x`` to ``matvec``/``rmatvec``."""

    def __init__(
        self,
        matvec: Callable,
        shape: Tuple[int, int],
        dtype,
        rmatvec: Optional[Callable] = None,
        params=(),
        device="cuda",
    ):
        self._matvec = matvec
        self._rmatvec = rmatvec
        self._shape = tuple(int(s) for s in shape)
        self._dtype = as_dtype(dtype)
        self.params = tuple(params)
        self.device = torch.device(device)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    def mv(self, x):
        return self._matvec(*self.params, x) if self.params else self._matvec(x)

    def rmv(self, x):
        if self._rmatvec is None:
            return super().rmv(x)
        return self._rmatvec(*self.params, x) if self.params else self._rmatvec(x)

    def mv_rows(self, Xr):
        # a user matvec typically takes a single (n,) vector only (e.g. it
        # reshapes to a grid): apply it row by row, as the JAX package
        # vmaps it
        return torch.stack([self.mv(r) for r in Xr])


class AdjointOperator(LinearOperator):
    def __init__(self, inner: LinearOperator):
        self.inner = inner

    @property
    def shape(self):
        n, m = self.inner.shape
        return (m, n)

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def device(self):
        return self.inner.device

    @property
    def mesh(self):
        return self.inner.mesh

    def mv(self, x):
        return self.inner.rmv(x)

    def rmv(self, x):
        return self.inner.mv(x)

    @property
    def H(self):
        return self.inner


class ScaledIdentityPlusOperator(LinearOperator):
    """(A + sigma*I) — used for shifts (e.g. inverse iteration helpers)."""

    def __init__(self, inner: LinearOperator, sigma):
        self.inner = inner
        self.sigma = sigma

    @property
    def shape(self):
        return self.inner.shape

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def device(self):
        return self.inner.device

    @property
    def mesh(self):
        return self.inner.mesh

    def mv(self, x):
        return self.inner.mv(x) + self.sigma * x

    def rmv(self, x):
        s = self.sigma
        s = s.conj() if isinstance(s, torch.Tensor) else s.conjugate()
        return self.inner.rmv(x) + s * x

    def mv_rows(self, Xr):
        return self.inner.mv_rows(Xr) + self.sigma * Xr


def as_operator(A, b=None, device="cuda") -> LinearOperator:
    """Coerce user input (operator / dense array / callable) to a
    LinearOperator.  A callable runs on ``b``'s device when ``b`` is a
    tensor; a tensor keeps its device; any other array goes to ``device``."""
    if isinstance(A, LinearOperator):
        return A
    if callable(A) and not hasattr(A, "ndim"):
        if b is None:
            raise ValueError("matrix-free callable needs `b` to infer shape/dtype")
        n = b.shape[0]
        dev = b.device if isinstance(b, torch.Tensor) else device
        return FunctionOperator(A, (n, n), b.dtype, device=dev)
    arr = (A if isinstance(A, torch.Tensor)
           else torch.as_tensor(A, device=device))
    if arr.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got shape {tuple(arr.shape)}")
    return MatrixOperator(arr)
