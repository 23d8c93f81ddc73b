"""Matrix-free constant-coefficient stencil operator (port of
``iterativesolvers_tpu/operators/stencil.py``).

The DIA format stores each diagonal explicitly (7 full-length streams for a
3-D Laplacian — ~7x the traffic of the vectors themselves); when the
coefficient along each offset is a constant, the SpMV needs no matrix data at
all: shifted reads of x, boundary masks from index arithmetic, and scalar
multiplies.

``laplacian(side, dims)`` builds the reference fixture operator
(test/laplace_matrix.jl:1-13) in this form; equality with ``laplace_dia`` is
tested element-wise.  ``GradientOperator`` is the rectangular forward
difference of a grid, also with no stored matrix data.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.cuda_stencil import stencil_apply, stencil_apply_rows, stencil_sum
from ..utils.dtypes import as_dtype
from .linear_operator import LinearOperator

__all__ = ["StencilOperator", "GradientOperator", "laplacian",
           "advection_diffusion_stencil"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _conj(c):
    return c.conjugate() if isinstance(c, complex) else c


class StencilOperator(LinearOperator):
    """y[i] = center * x[i] + sum_k coeff_k * x[i + offset_k], with Dirichlet
    masking on the grid axis each offset couples: an offset of ``±stride`` on
    a grid with that axis extent ``extent`` contributes only where the axis
    position stays inside [0, extent).

    ``terms`` is a tuple of (offset, stride, extent) per off-diagonal term;
    ``coeffs`` holds one scalar per term.  ``center`` and ``coeffs`` are
    kept as Python scalars rounded to ``dtype`` (the kernel takes them by
    value); the operator stores no tensor.  ``device`` is where its products
    run when the caller does not pass a tensor (the solvers' ``b``).
    """

    def __init__(self, n: int, center, terms: Tuple[Tuple[int, int, int], ...],
                 coeffs, dtype=torch.float32, device="cuda"):
        self.n = int(n)
        self.terms = tuple((int(o), int(s), int(e)) for (o, s, e) in terms)
        self._dtype = as_dtype(dtype)
        self.device = torch.device(device)
        # the operator holds no tensor: fail here, not at the first product,
        # when the device does not exist
        torch.empty(0, device=self.device)
        rnd = lambda c: torch.tensor(c, dtype=self._dtype).item()  # noqa: E731
        self.center = rnd(center)
        self.coeffs = tuple(rnd(c) for c in coeffs)
        if len(self.coeffs) != len(self.terms):
            raise ValueError("one coefficient per stencil term")

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self._dtype

    def _apply(self, x, conj: bool):
        """Plain PyTorch version for any x: 1-D or (n, k), any dtype; the
        result has ``promote(self.dtype, x.dtype)``.  The center comes first,
        then the terms in their order, as in the JAX package's ``_apply``."""
        cj = _conj if conj else (lambda c: c)
        order = [(0, cj(self.center), None)] + [
            (-off if conj else off, cj(c), (stride, extent))
            for (off, stride, extent), c in zip(self.terms, self.coeffs)]
        return stencil_sum(self.n, order,
                           x.to(torch.promote_types(self.dtype, x.dtype)))

    def _use_kernel(self, x) -> bool:
        # the kernel's function is defined for real 1-D f32 / bf16 vectors
        # (the rule of the TPU path, StencilOperator._pallas_plan); past the
        # kernel's limits the wrapper raises on CUDA
        return (x.ndim == 1 and x.dtype in _KERNEL_DTYPES
                and not self.dtype.is_complex)

    def _kernel(self, x, conj, with_dot=False):
        return stencil_apply(self.n, self.center, self.terms, self.coeffs, x,
                             conj=conj, with_dot=with_dot)

    def mv(self, x):
        if self._use_kernel(x):
            return self._kernel(x, conj=False)
        return self._apply(x, conj=False)

    def rmv(self, x):
        if self._use_kernel(x):
            return self._kernel(x, conj=True)
        return self._apply(x, conj=True)

    def mv_dot(self, x):
        if self._use_kernel(x):
            return self._kernel(x, conj=False, with_dot=True)
        return super().mv_dot(x)

    def mv_rows(self, Xr):
        """The product of each row of the (k, n) panel ``Xr``: where ``mv``
        takes the kernel (real f32 / bf16), the kernel once per row on a
        CUDA tensor and its plain version of the columns ``Xr.T`` on a CPU
        tensor (``stencil_apply_rows``); else the plain sum of ``Xr.T``.
        Each row is the same bits as ``mv`` of that row.  (The JAX package vmaps
        its XLA path here; the port keeps the kernel, PERF.md.)"""
        if Xr.dtype in _KERNEL_DTYPES and not self.dtype.is_complex:
            return stencil_apply_rows(self.n, self.center, self.terms,
                                      self.coeffs, Xr)
        return super().mv_rows(Xr)

    def to_dia(self):
        """Materialize as DIAMatrix (for tests / interop) on this device."""
        from .sparse import DIAMatrix

        n = self.n
        i = np.arange(n)
        offsets = [0] + [off for (off, _, _) in self.terms]
        data = [torch.full((n,), self.center, dtype=self.dtype)]
        for (off, stride, extent), c in zip(self.terms, self.coeffs):
            pos = (i // stride) % extent
            step = off // stride
            valid = ((pos + step >= 0) & (pos + step < extent)
                     & (i + off >= 0) & (i + off < n))
            d = torch.zeros(n, dtype=self.dtype)
            d[torch.from_numpy(valid)] = c
            data.append(d)
        order = np.argsort(offsets, kind="stable")
        return DIAMatrix([data[k] for k in order],
                         tuple(offsets[k] for k in order), (n, n),
                         device=self.device)


class GradientOperator(LinearOperator):
    """Matrix-free RECTANGULAR discrete-gradient operator of a regular grid:
    ``G : R^n -> R^{d*n}`` stacking the forward differences along each of
    the d grid axes (the operator class of the reference's rectangular
    least-squares / svdl workloads), with no stored matrix data: every
    ``mv`` / ``rmv`` is shifted reads and masks.

    ``dims`` is the grid shape, row-major (last axis fastest): axis k has
    stride ``prod(dims[k+1:])`` and extent ``dims[k]``.  Rows with the axis
    position at the upper boundary are zero (forward difference undefined).
    The products are eager torch, as the JAX package's are XLA fusions (no
    Pallas kernel); each axis's mask ``(i // stride) % extent < extent - 1``
    is computed once per device, not in every product.  ``x`` is (n,) or
    (n, k); the result keeps x's dtype.
    """

    def __init__(self, dims: Tuple[int, ...], dtype=torch.float32,
                 device="cuda"):
        self.dims = tuple(int(d) for d in dims)
        n = 1
        for d in self.dims:
            n *= d
        self.n = n
        terms = []
        stride = 1
        for d in reversed(self.dims):
            terms.append((stride, d))
            stride *= d
        self._terms = tuple(reversed(terms))   # (stride, extent) per axis
        self._dtype = as_dtype(dtype)
        self.device = torch.device(device)
        self._masks = {}

    @property
    def shape(self):
        return (len(self._terms) * self.n, self.n)

    @property
    def dtype(self):
        return self._dtype

    def _valid(self, device):
        """Per axis, the rows whose forward difference exists, on
        ``device`` (cached)."""
        if device not in self._masks:
            i = torch.arange(self.n, device=device)
            self._masks[device] = [(i // s) % e < e - 1
                                   for (s, e) in self._terms]
        return self._masks[device]

    def mv(self, x):
        n = self.n
        pad = max(s for (s, _) in self._terms)
        xp = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        blocks = []
        for (s, _), valid in zip(self._terms, self._valid(x.device)):
            mask = valid if x.ndim == 1 else valid[:, None]
            blocks.append(torch.where(mask, xp[s:s + n] - x, 0))
        return torch.cat(blocks)

    def rmv(self, y):
        # G^H block a: (D_a^T y_a)[j] = valid[j-s] y_a[j-s] - valid[j] y_a[j]
        n = self.n
        out = None
        for k, ((s, _), valid) in enumerate(zip(self._terms,
                                                self._valid(y.device))):
            ya = y[k * n:(k + 1) * n]
            mask = valid if y.ndim == 1 else valid[:, None]
            yv = torch.where(mask, ya, 0)
            up = torch.cat([yv.new_zeros((s,) + tuple(y.shape[1:])),
                            yv[:n - s]])          # y_a[j - s]
            contrib = up - yv
            out = contrib if out is None else out + contrib
        return out

    def to_csr(self):
        raise NotImplementedError(
            "GradientOperator.to_csr needs CSRMatrix, which the port does not "
            "have yet (ROADMAP.md, Queue A item 6)")


def advection_diffusion_stencil(N: int = 50, beta: float = 1000.0,
                                dtype=torch.float32,
                                device="cuda") -> StencilOperator:
    """The 3-D advection-diffusion benchmark operator (Δu + β·u_x, central
    differences — benchmark/advection_diffusion.jl:3-31 / the
    ``fixtures.advection_diffusion`` matrix) as a matrix-free stencil:
    every offset's coefficient is constant, only boundary masks vary."""
    n = N**3
    h = 1.0 / (N + 1)
    inv_h2 = -1.0 / (h * h)       # fixture scales the Laplacian by -1/h^2
    adv = beta / (2 * h)
    terms = (
        (1, 1, N), (-1, 1, N),          # x neighbours (advection axis)
        (N, N, N), (-N, N, N),          # y
        (N * N, N * N, N), (-N * N, N * N, N),  # z
    )
    coeffs = (
        -1.0 * inv_h2 + adv, -1.0 * inv_h2 - adv,
        -1.0 * inv_h2, -1.0 * inv_h2,
        -1.0 * inv_h2, -1.0 * inv_h2,
    )
    return StencilOperator(n, 6.0 * inv_h2, terms, coeffs, dtype=dtype,
                           device=device)


def laplacian(side: int, dims: int, dtype=torch.float32,
              device="cuda") -> StencilOperator:
    """The dims-D Laplacian on a side^dims grid as a matrix-free stencil —
    same matrix as ``fixtures.laplace_dia`` (test/laplace_matrix.jl:1-13),
    zero stored matrix data."""
    n = side**dims
    terms = []
    coeffs = []
    for k in range(dims):
        stride = side**k
        terms += [(stride, stride, side), (-stride, stride, side)]
        coeffs += [-1.0, -1.0]
    return StencilOperator(n, 2 * dims, tuple(terms), coeffs, dtype=dtype,
                           device=device)
