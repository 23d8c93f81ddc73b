"""Stored sparse formats (port of part of
``iterativesolvers_tpu/operators/sparse.py``).

This slice ports the diagonal format ``DIAMatrix`` and the value-stream
compression (``values_representable``, ``compress_values``); CSR, ELL, HYB
and BSR come with a later slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.cuda_spmv import (DIAG_DTYPES, dia_spmv, dia_spmv_dot,
                             dia_spmv_plain, dia_spmv_rows)
from ..utils.dtypes import as_dtype
from .linear_operator import LinearOperator

__all__ = ["DIAMatrix", "values_representable", "compress_values"]


class DIAMatrix(LinearOperator):
    """Diagonal storage: ``data[k, i] = A[i, i + offsets[k]]`` (0 where the
    column index falls outside the matrix).  The diagonals are a tuple of
    contiguous 1-D tensors on ``device``.

    ``mv`` / ``mv_dot`` send a 1-D real f32 x of a square matrix with f32,
    bf16 or int8 diagonals to the DIA kernel (``ops/cuda_spmv.py``), and
    everything else to the plain shifted-slice version, which promotes each
    product to ``promote(dtype, x.dtype)``.  ``mv_rows`` takes a (k, n)
    panel of such rows to the kernel once per row (``dia_spmv_rows``)."""

    def __init__(self, data, offsets: Tuple[int, ...], shape, device="cuda"):
        self.device = torch.device(device)
        rows = data if isinstance(data, (tuple, list)) else list(data)
        self.diags = tuple(
            (d if isinstance(d, torch.Tensor) else torch.as_tensor(d))
            .to(self.device).contiguous() for d in rows)
        self.offsets = tuple(int(o) for o in offsets)
        self._shape = (int(shape[0]), int(shape[1]))

    @property
    def data(self):
        """(ndiag, n) view for inspection (not the storage)."""
        return torch.stack(self.diags)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.diags[0].dtype

    def astype(self, dtype) -> "DIAMatrix":
        """Copy with the diagonals stored in ``dtype``.  The SpMV promotes
        each product to ``promote(dtype, x.dtype)``, so a bf16-valued matrix
        applied to an f32 vector still accumulates in f32 — only the value
        stream narrows (the diagonals are the dominant stream of the DIA
        SpMV)."""
        dt = as_dtype(dtype)
        return DIAMatrix(tuple(d.to(dt) for d in self.diags), self.offsets,
                         self._shape, device=self.device)

    def _use_kernel(self, x, ndim=1) -> bool:
        # past the kernel's limits the wrapper raises on CUDA
        n, m = self._shape
        return (x.ndim == ndim and x.dtype == torch.float32 and n == m
                and self.dtype in DIAG_DTYPES)

    def mv(self, x):
        if self._use_kernel(x):
            return dia_spmv(self.diags, self.offsets, x)
        return dia_spmv_plain(self.diags, self.offsets, x)

    def mv_dot(self, x):
        if self._use_kernel(x):
            return dia_spmv_dot(self.diags, self.offsets, x, x)
        return super().mv_dot(x)

    def mv_rows(self, Xr):
        if self._use_kernel(Xr, ndim=2):
            return dia_spmv_rows(self.diags, self.offsets, Xr)
        return super().mv_rows(Xr)

    def rmv(self, x):
        n, m = self._shape
        dt = torch.promote_types(self.dtype, x.dtype)
        pad = max(max((abs(o) for o in self.offsets), default=0), 1)
        y = torch.zeros((m + 2 * pad + max(n - m, 0),) + tuple(x.shape[1:]),
                        dtype=dt, device=x.device)
        for dk, off in zip(self.diags, self.offsets):
            # (A^H x)[i + off] += conj(data[k, i]) * x[i]
            d = dk.to(dt).conj()
            d = d if x.ndim == 1 else d[:, None]
            y[pad + off:pad + off + n] += d * x
        return y[pad:pad + m]

    def to_dense(self):
        n, m = self._shape
        out = torch.zeros(self._shape, dtype=self.dtype, device=self.device)
        rows = torch.arange(n, device=self.device)
        for d, off in zip(self.diags, self.offsets):
            cols = rows + off
            valid = (cols >= 0) & (cols < m)
            out[rows[valid], cols[valid]] += d[valid]
        return out

    def diagonal(self):
        """(main diagonal, presence mask ``d != 0``) as tensors on the
        device.  DIA storage cannot tell a structurally missing entry from an
        explicit zero, and the reference's DiagonalIndices throws for either
        (src/stationary_sparse.jl:18-28)."""
        k = min(self._shape)
        if 0 not in self.offsets:
            d = torch.zeros(k, dtype=self.dtype, device=self.device)
            return d, torch.zeros(k, dtype=torch.bool, device=self.device)
        d = self.diags[self.offsets.index(0)][:k]
        return d, d != 0


def _host_value_arrays(A):
    """The stored value tensors of a sparse-format operator."""
    if isinstance(A, DIAMatrix):
        return list(A.diags)
    raise TypeError(f"not a stored sparse format: {type(A).__name__}")


def values_representable(A, dtype) -> bool:
    """True iff every stored value of ``A`` round-trips
    ``A.dtype -> dtype -> A.dtype`` bit-exactly.

    Constant-coefficient discretizations (Laplacians, advection stencils,
    graph Laplacians with small-integer weights) typically store values that
    are exact in bfloat16 — for those matrices :func:`compress_values` is a
    pure bandwidth optimization with zero numerical effect, since every
    SpMV product promotes back to the vector dtype before accumulating."""
    dt = as_dtype(dtype)
    for w in _host_value_arrays(A):
        if w.dtype.is_complex and not dt.is_complex:
            # complex -> real narrowing drops imaginary parts; never treat
            # it as representable
            return False
        if not torch.equal(w.to(dt).to(w.dtype), w):
            return False
    return True


def compress_values(A, dtype=None, require_exact: bool = True):
    """Narrow the stored-value stream of a sparse-format operator.

    With ``dtype=None`` (default) picks the NARROWEST exact dtype from the
    ladder int8 -> bfloat16 (integer-valued matrices quarter the stream,
    bf16-representable ones halve it) and returns ``A`` unchanged when
    neither is exact.  With an explicit ``dtype``, returns ``A.astype(dtype)``
    when the values are exactly representable in it (or when
    ``require_exact=False`` — an explicit opt-in to a perturbed matrix),
    otherwise ``A`` unchanged.

    The matvec output dtype is unaffected: products promote to
    ``promote(value_dtype, x.dtype)``, so f32 solves stay f32 end to end
    while the dominant stream (the matrix values) narrows."""
    if dtype is None:
        for cand in (torch.int8, torch.bfloat16):
            if values_representable(A, cand):
                return A.astype(cand)
        return A
    if require_exact and not values_representable(A, dtype):
        return A
    return A.astype(dtype)
