"""Sparse triangular solves by level scheduling (port of
``iterativesolvers_tpu/ops/triangular.py``).

The reference's Gauss-Seidel/SOR sweeps are sequential CSC column loops
(``forward_sub!``/``backward_sub!``, src/stationary_sparse.jl:67-143).  Here,
as in the JAX package, the rows of the triangle are grouped into levels at
construction (on the host): row r is in level 1 + max(level of the rows it
depends on), so the rows of one level solve in parallel, and the sweep runs
the levels in order.  The dependency order of the sequential sweep is kept,
so the result matches it to rounding (the sum within a row may differ).

Layout (the JAX package's arrays, padded):

  rows  (nlev, wmax)        row index of each slot (n = padding)
  cols  (nlev, wmax, kmax)  dependency column of each row slot (0 = padding)
  vals  (nlev, wmax, kmax)  off-diagonal value (0 = padding)
  diag  (n,)                diagonal entries

The sweep is eager torch over the levels (the JAX package's ``fori_loop``,
an XLA computation, not a Pallas kernel): a level gathers ``y[cols]``,
multiplies by ``vals``, sums each row and writes ``y[r] = rhs[r] / d[r] -
acc / d[r]``.  Each level takes only its own rows (its padding slots are
sliced off with widths kept on the host, its views made once), so a level
is five launches and the solve reads nothing back to the host.  A (k, n) panel
of right-hand sides goes through the same loop once (the JAX package vmaps
the solve).

For 2/3-D stencil matrices the levels are grid anti-diagonals: O(sqrt(n)) or
O(n^{1/3}) sequential steps with wide parallel fronts.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native

__all__ = ["LevelScheduledTriangular", "level_arrays"]


def level_arrays(indptr, indices, data, n: int, lower: bool):
    """``(rows, cols, vals)``: the JAX package's padded level arrays of a
    strict-triangular CSR (int32 indices, values in ``data``'s dtype), packed
    without a loop over rows: rows sorted by level (ascending within one, as
    ``np.where`` lists them), each row's slot its rank within its level,
    each entry's position its rank within its row."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices)
    data = np.asarray(data)
    level = native.level_schedule(indptr, indices, n, lower)
    nlev = int(level.max()) + 1 if n else 1
    counts = np.bincount(level, minlength=nlev)
    wmax = max(int(counts.max()) if n else 0, 1)
    deg = np.diff(indptr)
    kmax = max(int(deg.max()) if n else 1, 1)
    # a stable sort of small integers (numpy's radix sort below 2^16)
    key = level.astype(np.int16 if nlev < 2**15 else np.int64)
    order = np.argsort(key, kind="stable")
    starts = np.cumsum(counts) - counts
    slot = np.empty(n, np.int64)
    slot[order] = np.arange(n, dtype=np.int64) - starts[level[order]]
    rows = np.full((nlev, wmax), n, dtype=np.int32)
    rows[level, slot] = np.arange(n, dtype=np.int32)
    owner = np.repeat(np.arange(n, dtype=np.int64), deg)
    # each entry's flat position: (its row's level, slot) and its rank
    flat = (level * wmax + slot)[owner] * kmax + (
        np.arange(owner.size, dtype=np.int64) - indptr[owner])
    cols = np.zeros(nlev * wmax * kmax, dtype=np.int32)
    vals = np.zeros(nlev * wmax * kmax, dtype=data.dtype)
    cols[flat] = indices
    vals[flat] = data
    cols = cols.reshape(nlev, wmax, kmax)
    vals = vals.reshape(nlev, wmax, kmax)
    return rows, cols, vals


def _on(a, device, dtype=None):
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        a = torch.from_numpy(a if a.flags.writeable else a.copy())
    return a.to(device=device, dtype=dtype).contiguous()


class LevelScheduledTriangular:
    """Solver for (D + T) y = rhs with T strictly triangular (see the module
    docstring for the arrays).  ``rows``, ``cols``, ``vals`` and ``diag`` are
    host arrays or tensors; they are kept on ``device``."""

    def __init__(self, rows, cols, vals, diag, n, device="cuda"):
        self.n = int(n)
        self.device = torch.device(device)
        rows = _on(rows, "cpu", torch.int64)
        # each level's width, read once here: the solve slices by it
        self.widths = [int(w) for w in (rows < self.n).sum(dim=1)]
        self.rows = rows.to(self.device)
        self.cols = _on(cols, self.device, torch.int32)
        self.vals = _on(vals, self.device)
        self.diag = _on(diag, self.device)
        # the rows in level order (the slots without padding), their
        # diagonal, and each level's views: its rows, its flat dependency
        # columns and its values (host work an apply does not repeat)
        self._order = rows[rows < self.n].to(self.device)
        self._d = self.diag[self._order]
        self._levels = [(self.cols[lev, :w].reshape(-1), self.vals[lev, :w])
                        for lev, w in enumerate(self.widths)]

    # -- host-side construction ---------------------------------------------
    @classmethod
    def from_csr(cls, indptr, indices, data, diag, lower: bool,
                 device="cuda"):
        """Build from the strict-triangular part (rows' off-diagonal deps).

        indptr/indices/data describe ONLY the strict off-diagonal entries of
        the triangle being solved; ``diag`` is the length-n diagonal."""
        diag = np.asarray(diag)
        n = diag.shape[0]
        rows, cols, vals = level_arrays(indptr, indices, data, n, lower)
        return cls(rows, cols, vals, diag, n, device=device)

    @property
    def nlevels(self):
        return int(self.rows.shape[0])

    @property
    def nbytes(self) -> int:
        """Device bytes of the level arrays and the diagonal."""
        return sum(t.numel() * t.element_size()
                   for t in (self.rows, self.cols, self.vals, self.diag))

    # -- device-side solve ----------------------------------------------------
    def solve(self, rhs, omega=None):
        """Solve (D/omega + T) y = rhs (omega=None means omega=1, i.e.
        (D + T) y = rhs) for a 1-D ``rhs`` or each row of a (k, n) panel.
        The SOR sweep is (D/w + L) x_new = (b - U x) + (1/w - 1) d*x, see
        solvers/stationary.py.  The result has the promoted dtype of the
        values, the diagonal, ``rhs`` and a tensor ``omega`` (a Python
        number promotes nothing, as JAX's weak type)."""
        n = self.n
        dtype = torch.promote_types(
            torch.promote_types(self.vals.dtype, rhs.dtype), self.diag.dtype)
        if isinstance(omega, torch.Tensor):
            dtype = torch.promote_types(dtype, omega.dtype)
        # promoted before the division (a 0-d tensor omega would not
        # promote a dimensioned one in torch; JAX divides in the result type)
        d = self._d.to(dtype)
        if omega is not None:
            d = d / omega
        lead = tuple(rhs.shape[:-1])
        ax = len(lead)
        # rhs / d in level order, gathered once and split by level: a level
        # is then y[rows] = rhs[rows] / d - (sum_k vals y[cols]) / d, five
        # launches (gather, product, row sum, addcdiv, scatter)
        rd = torch.index_select(rhs.to(dtype), ax, self._order) / d
        rd = rd.split(self.widths, dim=ax)
        ds = d.split(self.widths)
        rows = self._order.split(self.widths)
        levels = self._levels
        if self.vals.dtype != dtype:
            vals = self.vals.to(dtype)
            levels = [(c, vals[lev, :w]) for lev, ((c, _), w) in
                      enumerate(zip(levels, self.widths))]
        y = torch.zeros(lead + (n,), dtype=dtype, device=rhs.device)
        for lev, (c, v) in enumerate(levels):
            if not self.widths[lev]:
                continue
            g = torch.index_select(y, ax, c).view(lead + tuple(v.shape))
            acc = torch.sum(v * g, dim=-1)
            y.index_copy_(ax, rows[lev],
                          torch.addcdiv(rd[lev], acc, ds[lev], value=-1))
        return y
