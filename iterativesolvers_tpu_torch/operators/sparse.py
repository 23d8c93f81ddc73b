"""Stored sparse formats (port of ``iterativesolvers_tpu/operators/sparse.py``).

  * ``CSRMatrix`` — the interchange format: ``from_coo`` (the native counting
    sort), conversions to the other formats, RCM reordering and
    ``auto_format``, the JAX package's cost model, which picks DIA, ELL, HYB
    or BSR.
  * ``ELLMatrix`` — padded fixed-width rows (n, w): one gather, a multiply
    and a row sum.
  * ``HYBMatrix`` — ELL rows of a chosen width plus a row-sorted COO tail.
  * ``DIAMatrix`` — diagonal storage, whose CG / GMRES products launch the
    DIA kernel (``ops/cuda_spmv.py``).
  * ``BSRMatrix`` — dense (bs, bs) blocks: a block gather, each block's
    product and a sum over block rows.

Construction and conversion run on the host in numpy, with the JAX
package's formulas, so each gives the JAX package's arrays; the products
run on the operator's ``device`` (default ``"cuda"``).  The JAX package
computes the CSR, ELL, HYB and BSR products as XLA gathers and segment sums,
not Pallas kernels, so they are eager torch here, the same code on every
device.  Sums over sorted rows (``mv`` of CSR, HYB's tail, BSR) go through
``torch.segment_reduce`` over row offsets: each row summed in order, the
same bits on every run.  An adjoint product without a precomputed adjoint
scatters onto unsorted columns with ``index_add_`` (atomics on CUDA: held
to a tolerance, not to its bits), as the JAX package's scatter.  Indices
are stored as int32, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import native
from ..ops.cuda_spmv import (DIAG_DTYPES, dia_spmv, dia_spmv_dot,
                             dia_spmv_plain, dia_spmv_rows)
from ..utils.dtypes import as_dtype, host_tensor
from .linear_operator import LinearOperator

__all__ = ["CSRMatrix", "ELLMatrix", "HYBMatrix", "DIAMatrix", "BSRMatrix",
           "csr_from_dense", "dia_from_dense", "values_representable",
           "compress_values"]


def _on(a, device, dtype=None) -> torch.Tensor:
    """``a`` (a tensor or a host array) as a contiguous tensor on
    ``device``, in ``dtype`` if one is given."""
    t = a if isinstance(a, torch.Tensor) else host_tensor(a)
    return t.to(device=device, dtype=dtype).contiguous()


def _host(a, dtype=None) -> np.ndarray:
    """``a`` (a tensor or a host array) as a numpy array (a CPU tensor's
    own storage; bfloat16 as float32, which holds it exactly)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        a = (a.float() if a.dtype == torch.bfloat16 else a).cpu().numpy()
    else:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
    return a if dtype is None else a.astype(dtype, copy=False)


def _dtype_of(a) -> torch.dtype:
    return a.dtype if isinstance(a, torch.Tensor) else as_dtype(
        np.asarray(a).dtype)


def _validate_coo_indices(rows, cols, shape):
    """Raise ValueError on out-of-range COO indices (hostile or malformed
    input would otherwise corrupt memory in the native counting sort)."""
    n_rows, n_cols = int(shape[0]), int(shape[1])
    if rows.size and (
        int(rows.min()) < 0 or int(rows.max()) >= n_rows
        or int(cols.min()) < 0 or int(cols.max()) >= n_cols
    ):
        raise ValueError(
            f"COO indices out of range for shape ({n_rows}, {n_cols}): "
            f"rows in [{rows.min()}, {rows.max()}], "
            f"cols in [{cols.min()}, {cols.max()}]")


def _segment_sum(vals, offsets):
    """Along axis 0, the sum of each run ``vals[offsets[i]:offsets[i+1]]``
    (0 for an empty run), each run summed in order: the same bits on every
    run.  ``torch.segment_reduce`` has no complex kernel, so a complex sum
    is its real and imaginary sums.  A 1-D ``vals`` goes in as one column:
    on an H100 the 1-D form took ~11 ms for 10M runs of 7, the column form
    ~0.18 ms, with the same bits (``tools/sparse_sum_ab.py``)."""
    if vals.is_complex():
        return torch.complex(_segment_sum(vals.real, offsets),
                             _segment_sum(vals.imag, offsets))
    if vals.ndim == 1:
        return torch.segment_reduce(vals[:, None], "sum", offsets=offsets,
                                    axis=0)[:, 0]
    return torch.segment_reduce(vals, "sum", offsets=offsets, axis=0)


def _diagonal_offsets(rows, cols, shape):
    """The sorted distinct ``cols - rows`` of a pattern (np.unique's
    values), counted in O(nnz + n + m) by a bincount over the offsets'
    range instead of a sort."""
    n, m = int(shape[0]), int(shape[1])
    hits = np.bincount(cols - rows + (n - 1), minlength=n + m - 1)
    return np.flatnonzero(hits) - (n - 1)


def _distinct_count(keys):
    """np.unique(keys).size, by a stable sort: a CSR matrix's keys come in
    sorted runs (one a row), which numpy's stable sort merges faster than
    np.unique's quicksort sorts them."""
    if keys.size == 0:
        return 0
    k = np.sort(keys, kind="stable")
    return 1 + int(np.count_nonzero(k[1:] != k[:-1]))


def _sorted_offsets(ids, count):
    """(order, offsets): a stable order that sorts ``ids`` (None if they
    are sorted already) and the (count + 1) run offsets of the sorted ids,
    int64."""
    ids = np.asarray(ids, np.int64)
    order = None
    if ids.size > 1 and bool((ids[1:] < ids[:-1]).any()):
        order = np.argsort(ids, kind="stable")
        ids = ids[order]
    offsets = np.zeros(count + 1, np.int64)
    np.cumsum(np.bincount(ids, minlength=count), out=offsets[1:])
    return order, offsets


class CSRMatrix(LinearOperator):
    """Compressed sparse row.  ``row_ids`` (nnz,) is kept beside ``indptr``
    for the host conversions and the adjoint's gather; ``mv`` sums each
    row's products in order over ``indptr`` (``torch.segment_reduce``)."""

    def __init__(self, data, indices, indptr, shape, row_ids=None,
                 device="cuda"):
        self.device = torch.device(device)
        self._shape = (int(shape[0]), int(shape[1]))
        self.data = _on(data, self.device)
        if self.data.shape[0] >= 2**31:
            raise ValueError("at most 2^31 - 1 stored values: indices and "
                             "row pointers are int32")
        self.indices = _on(indices, self.device, torch.int32)
        self.indptr = _on(indptr, self.device, torch.int32)
        if row_ids is None:
            counts = np.diff(_host(indptr, np.int64))
            row_ids = np.repeat(np.arange(self._shape[0], dtype=np.int32),
                                counts)
        self.row_ids = _on(row_ids, self.device, torch.int32)

    def _host(self, name):
        a = _host(getattr(self, name))
        return a.astype(np.int64) if name == "indptr" else a

    # -- construction --------------------------------------------------------
    @classmethod
    def from_coo(cls, rows, cols, vals, shape, device="cuda"):
        """Sorted CSR with duplicates summed.  Real values go through the
        native counting sort (summed in f64, then cast to the values'
        dtype), complex ones through its numpy version."""
        rows = _host(rows, np.int64)
        cols = _host(cols, np.int64)
        dtype = _dtype_of(vals)
        vals = _host(vals)
        # indices may come from untrusted files (MatrixMarket): validate
        # before they reach the native counting sort, which indexes raw
        # buffers with them
        _validate_coo_indices(rows, cols, shape)
        if not np.iscomplexobj(vals):
            indptr, indices, data = native.coo_to_csr(rows, cols, vals,
                                                      shape[0])
        else:
            indptr, indices, data = native._coo_to_csr_numpy(
                rows, cols, vals, shape[0])
        return cls(_on(data, "cpu", dtype), indices, indptr, shape,
                   device=device)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self):
        return int(self.data.shape[0])

    def astype(self, dtype) -> "CSRMatrix":
        """Copy with the stored values in ``dtype`` (structure unchanged).
        See :func:`compress_values` for the exactness-checked form."""
        return CSRMatrix(self.data.to(as_dtype(dtype)), self.indices,
                         self.indptr, self._shape, row_ids=self.row_ids,
                         device=self.device)

    def mv(self, x):
        # x: (m,) or (m, k)
        d = self.data if x.ndim == 1 else self.data[:, None]
        return _segment_sum(d * torch.index_select(x, 0, self.indices),
                            self.indptr)

    def rmv(self, x):
        # A^H x by a scatter-add onto column ids (no transposed copy)
        d = self.data.conj()
        d = d if x.ndim == 1 else d[:, None]
        vals = d * torch.index_select(x, 0, self.row_ids)
        out = vals.new_zeros((self._shape[1],) + tuple(x.shape[1:]))
        return out.index_add_(0, self.indices, vals)

    def to_dense(self):
        out = torch.zeros(self._shape, dtype=self.dtype, device=self.device)
        return out.index_put_((self.row_ids.long(), self.indices.long()),
                              self.data, accumulate=True)

    def _host_coo(self):
        """(rows int64, cols int64, values) on the host."""
        return (self._host("row_ids").astype(np.int64),
                self._host("indices").astype(np.int64), self._host("data"))

    def to_ell(self, row_width: int | None = None) -> "ELLMatrix":
        indptr = self._host("indptr")
        counts = np.diff(indptr)
        k = int(counts.max()) if row_width is None else int(row_width)
        k = max(k, 1)
        n = self._shape[0]
        host_data = self._host("data")
        host_idx = self._host("indices")
        if not np.iscomplexobj(host_data):
            cols, data = native.csr_to_ell(indptr, host_idx, host_data, n, k)
        else:
            cols, data = native._csr_to_ell_numpy(indptr, host_idx,
                                                  host_data, n, k)
        return ELLMatrix(_on(data, "cpu", self.dtype), cols, self._shape,
                         device=self.device)

    def to_hyb(self, row_width: int | None = None,
               tail_cost: float = 4.0) -> "HYBMatrix":
        """Convert to hybrid ELL + COO-tail form (see :class:`HYBMatrix`).

        ``row_width`` defaults to the w minimizing the modeled SpMV cost
        ``n*w + tail_cost * tail_nnz(w)`` over the distinct row degrees —
        gathered ELL elements cost 1, tail elements cost ``tail_cost``
        (gather + sorted scatter-add).
        """
        indptr = self._host("indptr")
        counts = np.diff(indptr)
        n = self._shape[0]
        if row_width is None:
            row_width, _ = _hyb_width(counts, n, tail_cost)
        w = max(int(row_width), 1)
        ell = self.to_ell(row_width=w)  # keeps the first w entries per row
        data = self._host("data")
        idx = self._host("indices")
        # an entry is in the tail iff its position within its row is >= w
        row_ids = self._host("row_ids")
        pos = np.arange(row_ids.size, dtype=np.int64) - indptr[row_ids]
        tail = pos >= w
        return HYBMatrix(ell, row_ids[tail].astype(np.int32),
                         idx[tail].astype(np.int32),
                         _on(data[tail], "cpu", self.dtype), self._shape)

    def to_dia(self) -> "DIAMatrix":
        rows, cols, vals = self._host_coo()
        offsets = _diagonal_offsets(rows, cols, self._shape)
        n = self._shape[0]
        data = np.zeros((offsets.size, n), dtype=vals.dtype)
        # one vectorized scatter (auto_format's RCM -> DIA path runs it on
        # large matrices)
        off_idx = np.searchsorted(offsets, cols - rows)
        data[off_idx, rows] = vals
        return DIAMatrix([_on(d, "cpu", self.dtype) for d in data],
                         tuple(int(o) for o in offsets), self._shape,
                         device=self.device)

    def diagonal(self):
        """(main diagonal, presence mask) as tensors on the device; the mask
        is False where a diagonal entry is structurally absent (mirrors
        DiagonalIndices' SingularException check,
        src/stationary_sparse.jl:18-20, checked at the call site)."""
        rows, cols, vals = self._host_coo()
        mask = rows == cols
        d = np.zeros(min(self._shape), dtype=vals.dtype)
        present = np.zeros(min(self._shape), dtype=bool)
        d[rows[mask]] = vals[mask]
        present[rows[mask]] = True
        return (_on(d, self.device, self.dtype),
                torch.from_numpy(present).to(self.device))

    # -- reordering / format selection ---------------------------------------
    def permute(self, perm) -> "CSRMatrix":
        """Symmetric permutation ``B = A[perm, :][:, perm]`` (square only):
        ``B[i, j] = A[perm[i], perm[j]]``.  To solve ``A x = b`` with the
        permuted operator, solve ``B y = b[perm]`` and scatter back
        ``x[perm] = y``."""
        n, m = self._shape
        if n != m:
            raise ValueError("symmetric permutation requires a square matrix")
        perm = _host(perm, np.int64)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        rows, cols, _ = self._host_coo()
        return CSRMatrix.from_coo(inv[rows], inv[cols], self.data.cpu(),
                                  self._shape, device=self.device)

    def rcm(self):
        """(perm, bandwidth): reverse Cuthill-McKee ordering of the
        symmetrized pattern — the bandwidth-reducing preprocessing that
        exposes banded / DIA structure."""
        n = self._shape[0]
        if n != self._shape[1]:
            raise ValueError("RCM requires a square matrix")
        # the symmetrized pattern (values irrelevant), sorted on the host
        r, c, _ = self._host_coo()
        rs = np.concatenate([r, c])
        cs = np.concatenate([c, r])
        indptr, indices, _ = native.coo_to_csr(rs, cs,
                                               np.ones(rs.size, np.float64), n)
        return native.rcm_order(indptr, indices, n)

    def structure_stats(self) -> dict:
        """Host-side structure metrics feeding :meth:`auto_format`."""
        rows, cols, _ = self._host_coo()
        return self._structure_stats(rows, cols)

    def _structure_stats(self, rows, cols) -> dict:
        counts = np.diff(self._host("indptr"))
        offsets = _diagonal_offsets(rows, cols, self._shape)
        ndiag = int(offsets.size)
        bw = int(np.abs(offsets).max()) if offsets.size else 0
        return {
            "n": self._shape[0],
            "nnz": int(rows.size),
            "max_degree": int(counts.max()) if counts.size else 0,
            "mean_degree": float(counts.mean()) if counts.size else 0.0,
            "ndiag": ndiag,
            "bandwidth": bw,
        }

    def auto_format(self, *, tail_cost: float = 4.0, try_rcm: bool = True):
        """Pick a SpMV format by the JAX package's cost model, in streamed /
        gathered elements:

          DIA  : ndiag * n           streamed   (weight 1)
          ELL  : n * maxdeg          gathered   (weight ``tail_cost``)
          HYB  : n * w + tail(w)     gathered
          BSR  : nblk * bs^2         streamed + one small gather per block

        The formulas, the candidates' order (``min`` breaks ties by it) and
        the RCM gate (more than 48 diagonals) are the JAX package's, so both
        pick the same format for the same matrix.  Square matrices with
        more than 48 diagonals test an RCM reordering first: if it shrinks
        the diagonal count enough that DIA wins, the permuted DIA operator
        is returned.  Returns ``(op, perm)`` where ``perm`` is None when no
        reordering was applied.  Distinct offsets and blocks are counted
        exactly, by a bincount and a stable sort (the counts np.unique gives
        the JAX package)."""
        rows, cols, _ = self._host_coo()
        stats = self._structure_stats(rows, cols)
        n = stats["n"]
        square = self._shape[0] == self._shape[1]

        GATHER = tail_cost  # relative cost of a gathered vs streamed element

        candidates = {}  # name -> (cost, builder)
        if stats["ndiag"] > 0:
            candidates["dia"] = (
                float(stats["ndiag"]) * n,
                lambda: (self.to_dia(), None),
            )
        candidates["ell"] = (
            GATHER * float(max(stats["max_degree"], 1)) * n,
            lambda: (self.to_ell(), None),
        )
        # HYB cost: the objective to_hyb minimizes, scaled by GATHER into
        # this model's streamed units; its argmin w is passed to to_hyb so
        # the built operator is the one that was costed
        counts = np.diff(self._host("indptr"))
        if counts.size:
            hyb_w, hyb_cost = _hyb_width(counts, n, tail_cost)
            candidates["hyb"] = (
                GATHER * hyb_cost,
                lambda: (self.to_hyb(row_width=hyb_w,
                                     tail_cost=tail_cost), None),
            )
        # BSR: the block count of a few block sizes
        for bs in (2, 4, 8):
            if self._shape[0] % bs or self._shape[1] % bs:
                continue
            nblk = _distinct_count(
                (rows // bs) * (self._shape[1] // bs) + cols // bs)
            # streamed block data + one gathered x block per block
            cost = float(nblk) * bs * bs + GATHER * float(nblk) * bs
            candidates[f"bsr{bs}"] = (
                cost,
                (lambda b: (lambda: (BSRMatrix.from_csr(self, b), None)))(bs),
            )
        best_name = min(candidates, key=lambda k: candidates[k][0])

        if try_rcm and square and stats["ndiag"] > 48:
            perm, _ = self.rcm()
            # the permuted pattern's own diagonal count (at most 2 bw + 1);
            # only worth it if the banded DIA beats the best unpermuted
            # format
            inv = np.empty(n, np.int64)
            inv[perm] = np.arange(n)
            ndiag_rcm = int(_diagonal_offsets(inv[rows], inv[cols],
                                              self._shape).size)
            if float(ndiag_rcm) * n < candidates[best_name][0]:
                return self.permute(perm).to_dia(), perm

        op, _ = candidates[best_name][1]()
        return op, None


def _hyb_width(counts, n, tail_cost):
    """(w, cost): the ELL width of a HYB split of rows of ``counts``
    entries that minimizes the modeled SpMV cost ``n*w + tail_cost *
    tail_nnz(w)`` over the distinct row degrees and 1 (the first of equal
    costs), and that cost.  O(#degrees * n) on the host."""
    cands = np.unique(np.concatenate([[1], counts[counts > 0]]))
    best_w, best_cost = 1, float("inf")
    for w in cands:
        tail = int(np.maximum(counts - w, 0).sum())
        cost = n * int(w) + tail_cost * tail
        if cost < best_cost:
            best_w, best_cost = int(w), cost
    return best_w, best_cost


def _ell_host_coo(data, cols):
    """(rows, cols, values) of the stored nonzeros of ELL arrays."""
    rows = np.broadcast_to(np.arange(cols.shape[0])[:, None], cols.shape)
    mask = data != 0
    return rows[mask], cols[mask], data[mask]


class ELLMatrix(LinearOperator):
    """Padded fixed-width-row format: ``data`` / ``cols`` are (n, w); padding
    has ``cols = 0, data = 0`` so the gather stays in bounds and adds 0.

    ``rmv`` is a scatter onto unsorted column ids.  Solvers that use the
    adjoint every iteration (lsqr / lsmr / qmr / svdl) should call
    :meth:`with_adjoint` once: it precomputes A^H in ELL form, so the
    adjoint product is the same gather (2x storage)."""

    def __init__(self, data, cols, shape, adj: "ELLMatrix | None" = None,
                 gather_chunk_rows: int | None = None, device="cuda"):
        self.device = torch.device(device)
        self.data = _on(data, self.device)
        self.cols = _on(cols, self.device, torch.int32)
        self._shape = (int(shape[0]), int(shape[1]))
        self.adj = adj
        # optional gather chunking: the (n, w) gather in row chunks of this
        # many rows, one after another (bounds the size of any one gather)
        self._gather_chunk_rows = (int(gather_chunk_rows)
                                   if gather_chunk_rows else None)

    def _host(self, name):
        return _host(getattr(self, name))

    def _copy(self, **kw) -> "ELLMatrix":
        args = dict(data=self.data, cols=self.cols, shape=self._shape,
                    adj=self.adj, gather_chunk_rows=self._gather_chunk_rows,
                    device=self.device)
        args.update(kw)
        return ELLMatrix(**args)

    def with_adjoint(self) -> "ELLMatrix":
        """A copy carrying a precomputed ELL-form adjoint."""
        if self.adj is not None:
            return self
        rows, cols, vals = self.to_csr()._host_coo()
        n, m = self._shape
        adj = CSRMatrix.from_coo(cols, rows, _on(np.conj(vals), "cpu",
                                                 self.dtype),
                                 (m, n), device=self.device).to_ell()
        if self._gather_chunk_rows:
            adj = adj.with_chunked_gather(self._gather_chunk_rows)
        return self._copy(adj=adj)

    def with_chunked_gather(self, chunk_rows: int) -> "ELLMatrix":
        """A copy whose SpMV splits the row gather into ``chunk_rows``
        chunks (the adjoint, if present, is chunked too)."""
        adj = (self.adj.with_chunked_gather(chunk_rows)
               if self.adj is not None else None)
        return self._copy(adj=adj, gather_chunk_rows=chunk_rows)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def row_width(self):
        return int(self.data.shape[1])

    def astype(self, dtype) -> "ELLMatrix":
        """Copy with the stored values in ``dtype`` (structure unchanged)."""
        adj = self.adj.astype(dtype) if self.adj is not None else None
        return self._copy(data=self.data.to(as_dtype(dtype)), adj=adj)

    @staticmethod
    def _rows_product(data, cols, x):
        # x: (m,) or (m, k); the gathered rows (n, w) or (n, w, k) against
        # the (n, w) values, summed over w
        g = torch.index_select(x, 0, cols.reshape(-1))
        g = g.reshape(tuple(cols.shape) + tuple(x.shape[1:]))
        d = data if x.ndim == 1 else data[..., None]
        return torch.sum(d * g, dim=1)

    def mv(self, x):
        ck = self._gather_chunk_rows
        n = self.cols.shape[0]
        if ck and ck < n:
            return torch.cat([
                self._rows_product(self.data[r0:r0 + ck],
                                   self.cols[r0:r0 + ck], x)
                for r0 in range(0, n, ck)])
        return self._rows_product(self.data, self.cols, x)

    def rmv(self, x):
        if self.adj is not None:
            return self.adj.mv(x)
        d = self.data.conj() if x.ndim == 1 else self.data.conj()[..., None]
        vals = d * x[:, None]  # (n, w) or (n, w, k)
        flat = vals.reshape((-1,) + tuple(vals.shape[2:]))
        out = flat.new_zeros((self._shape[1],) + tuple(vals.shape[2:]))
        return out.index_add_(0, self.cols.reshape(-1), flat)

    def to_dense(self):
        out = torch.zeros(self._shape, dtype=self.dtype, device=self.device)
        rows = torch.arange(self._shape[0], device=self.device)[:, None]
        return out.index_put_((rows.expand(self.cols.shape),
                               self.cols.long()), self.data, accumulate=True)

    def to_csr(self) -> "CSRMatrix":
        rows, cols, vals = _ell_host_coo(self._host("data"),
                                         self._host("cols"))
        return CSRMatrix.from_coo(rows, cols, _on(vals, "cpu", self.dtype),
                                  self._shape, device=self.device)


class HYBMatrix(LinearOperator):
    """Hybrid ELL + COO-tail format for skewed row-degree distributions.

    Plain ELL pads every row to the maximum degree, so a handful of heavy
    rows multiply the gathered-element count of the whole SpMV.  HYB keeps
    the first ``w`` entries of each row in ELL form and spills the overflow
    into a small row-sorted COO tail, summed by row in order
    (:meth:`CSRMatrix.to_hyb` picks ``w`` by cost model).  ``with_adjoint``
    precomputes A^H in HYB form, so the adjoint product is the same kind of
    product (as :class:`ELLMatrix`)."""

    def __init__(self, ell: ELLMatrix, tail_rows, tail_cols, tail_vals,
                 shape, adj: "HYBMatrix | None" = None):
        self.ell = ell
        self.device = ell.device
        self._shape = (int(shape[0]), int(shape[1]))
        self.adj = adj
        # the tail sorted by row (stable) and the offsets of each row that
        # has a tail: mv sums each such row's run in order
        order, offsets = _sorted_offsets(_host(tail_rows), self._shape[0])
        if order is not None:
            tail_rows, tail_cols, tail_vals = (
                _host(tail_rows)[order], _host(tail_cols)[order],
                _on(tail_vals, "cpu")[torch.from_numpy(order)])
        runs = np.flatnonzero(np.diff(offsets))
        self.tail_rows = _on(tail_rows, self.device, torch.int32)
        self.tail_cols = _on(tail_cols, self.device, torch.int32)
        self.tail_vals = _on(tail_vals, self.device)
        self._tail_row_set = _on(runs, self.device)
        self._tail_offsets = _on(np.concatenate([offsets[runs],
                                                 offsets[-1:]]), self.device)

    def _host(self, name):
        return _host(getattr(self, name))

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.ell.dtype

    @property
    def tail_nnz(self):
        return int(self.tail_vals.shape[0])

    def astype(self, dtype) -> "HYBMatrix":
        """Copy with the stored values in ``dtype`` (structure unchanged)."""
        adj = self.adj.astype(dtype) if self.adj is not None else None
        return HYBMatrix(self.ell.astype(dtype), self.tail_rows,
                         self.tail_cols, self.tail_vals.to(as_dtype(dtype)),
                         self._shape, adj=adj)

    def mv(self, x):
        y = self.ell.mv(x)
        if self.tail_nnz == 0:
            return y
        v = self.tail_vals if x.ndim == 1 else self.tail_vals[:, None]
        contrib = v * torch.index_select(x, 0, self.tail_cols)
        rows = self._tail_row_set
        y[rows] = y[rows] + _segment_sum(contrib, self._tail_offsets)
        return y

    def rmv(self, x):
        if self.adj is not None:
            return self.adj.mv(x)
        y = self.ell.rmv(x)
        if self.tail_nnz == 0:
            return y
        v = self.tail_vals.conj()
        v = v if x.ndim == 1 else v[:, None]
        contrib = v * torch.index_select(x, 0, self.tail_rows)
        return y.index_add_(0, self.tail_cols, contrib.to(y.dtype))

    def with_adjoint(self) -> "HYBMatrix":
        """A copy carrying a precomputed HYB-form adjoint."""
        if self.adj is not None:
            return self
        rows, cols, vals = self.to_csr()._host_coo()
        n, m = self._shape
        adj = CSRMatrix.from_coo(cols, rows, _on(np.conj(vals), "cpu",
                                                 self.dtype),
                                 (m, n), device=self.device).to_hyb()
        return HYBMatrix(self.ell, self.tail_rows, self.tail_cols,
                         self.tail_vals, self._shape, adj=adj)

    def to_dense(self):
        out = self.ell.to_dense()
        if self.tail_nnz == 0:
            return out
        return out.index_put_((self.tail_rows.long(), self.tail_cols.long()),
                              self.tail_vals, accumulate=True)

    def to_csr(self) -> "CSRMatrix":
        rows, cols, vals = _ell_host_coo(self.ell._host("data"),
                                         self.ell._host("cols"))
        all_rows = np.concatenate([rows, self._host("tail_rows")])
        all_cols = np.concatenate([cols, self._host("tail_cols")])
        all_vals = np.concatenate([vals, self._host("tail_vals")])
        return CSRMatrix.from_coo(all_rows, all_cols,
                                  _on(all_vals, "cpu", self.dtype),
                                  self._shape, device=self.device)


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

    def to_csr(self) -> "CSRMatrix":
        n, m = self._shape
        all_rows, all_cols, all_vals = [], [], []
        i = np.arange(n)
        for dk, off in zip(self.diags, self.offsets):
            dk = _host(dk)
            cols = i + off
            mask = (cols >= 0) & (cols < m) & (dk != 0)
            all_rows.append(i[mask])
            all_cols.append(cols[mask])
            all_vals.append(dk[mask])
        return CSRMatrix.from_coo(
            np.concatenate(all_rows), np.concatenate(all_cols),
            _on(np.concatenate(all_vals), "cpu", self.dtype), self._shape,
            device=self.device)

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


class BSRMatrix(LinearOperator):
    """Block compressed sparse row: ``blocks`` (nblk, bs, bs) dense blocks,
    ``block_cols`` (nblk,) block-column ids, ``block_row_ids`` (nblk,)
    block-row ids (sorted here if they are not).  ``mv`` gathers x's blocks,
    multiplies each by its block and sums each block row in order — the
    format of FEM / multi-dof matrices."""

    def __init__(self, blocks, block_cols, block_row_ids, shape,
                 device="cuda"):
        self.device = torch.device(device)
        self._shape = (int(shape[0]), int(shape[1]))
        bs = int(blocks.shape[1])
        if shape[0] % bs or shape[1] % bs:
            raise ValueError("matrix shape must be divisible by the block size")
        order, offsets = _sorted_offsets(_host(block_row_ids),
                                         self._shape[0] // bs)
        if order is not None:
            blocks = _on(blocks, "cpu")[torch.from_numpy(order)]
            block_cols = _host(block_cols)[order]
            block_row_ids = _host(block_row_ids)[order]
        self.blocks = _on(blocks, self.device)
        self.block_cols = _on(block_cols, self.device, torch.int32)
        self.block_row_ids = _on(block_row_ids, self.device, torch.int32)
        self._block_offsets = _on(offsets, self.device)

    @classmethod
    def from_csr(cls, csr: "CSRMatrix", block_size: int) -> "BSRMatrix":
        n, m = csr.shape
        bs = int(block_size)
        if n % bs or m % bs:
            raise ValueError("matrix shape must be divisible by the block size")
        rows, cols, vals = csr._host_coo()
        keys = (rows // bs) * (m // bs) + cols // bs
        uniq, inv = np.unique(keys, return_inverse=True)
        blocks = np.zeros((uniq.size, bs, bs), vals.dtype)
        blocks[inv, rows % bs, cols % bs] = vals
        return cls(_on(blocks, "cpu", csr.dtype), uniq % (m // bs),
                   uniq // (m // bs), (n, m), device=csr.device)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def block_size(self):
        return int(self.blocks.shape[1])

    @property
    def nnz(self):
        return int(self.blocks.numel())

    def astype(self, dtype) -> "BSRMatrix":
        """Copy with the stored blocks in ``dtype`` (structure unchanged)."""
        return BSRMatrix(self.blocks.to(as_dtype(dtype)), self.block_cols,
                         self.block_row_ids, self._shape, device=self.device)

    def _block_product(self, blocks, ids, x, n_in):
        """Each block (promoted to x's type) times x's block ``ids[b]``:
        (nblk, bs) or (nblk, bs, k).  The batched product of many small
        blocks is a broadcast product and a sum over the block's columns:
        on an H100 it took ~0.28 ms for 1.75M 4 x 4 blocks, where cuBLAS's
        batched GEMM (``bmm``) took ~1.5 ms (``tools/sparse_sum_ab.py``)."""
        bs = self.block_size
        dt = torch.promote_types(blocks.dtype, x.dtype)
        xb = x.reshape((n_in // bs, bs) + tuple(x.shape[1:])).to(dt)
        g = torch.index_select(xb, 0, ids)
        B = blocks.to(dt)
        if x.ndim == 1:
            return torch.sum(B * g[:, None, :], dim=2)
        return torch.sum(B[..., None] * g[:, None, :, :], dim=2)

    def mv(self, x):
        prod = self._block_product(self.blocks, self.block_cols, x,
                                   self._shape[1])
        yb = _segment_sum(prod, self._block_offsets)
        return yb.reshape((self._shape[0],) + tuple(x.shape[1:]))

    def rmv(self, x):
        bs = self.block_size
        prod = self._block_product(self.blocks.conj().transpose(1, 2),
                                   self.block_row_ids, x, self._shape[0])
        yb = prod.new_zeros((self._shape[1] // bs,) + tuple(prod.shape[1:]))
        yb.index_add_(0, self.block_cols, prod)
        return yb.reshape((self._shape[1],) + tuple(x.shape[1:]))

    def to_dense(self):
        bs = self.block_size
        out = torch.zeros(self._shape, dtype=self.dtype, device=self.device)
        ar = torch.arange(bs, device=self.device)
        rows = (self.block_row_ids.long() * bs)[:, None, None] + ar[:, None]
        cols = (self.block_cols.long() * bs)[:, None, None] + ar[None, :]
        out[rows.expand(self.blocks.shape), cols.expand(self.blocks.shape)] \
            = self.blocks
        return out


def csr_from_dense(mat, tol: float = 0.0, device="cuda") -> CSRMatrix:
    """The entries of ``mat`` with ``|a| > tol`` as a :class:`CSRMatrix`."""
    dtype = _dtype_of(mat)
    mat = _host(mat)
    rows, cols = np.nonzero(np.abs(mat) > tol)
    return CSRMatrix.from_coo(rows, cols, _on(mat[rows, cols], "cpu", dtype),
                              mat.shape, device=device)


def dia_from_dense(mat, device="cuda") -> DIAMatrix:
    return csr_from_dense(mat, device=device).to_dia()


def _host_value_arrays(A):
    """The stored value tensors of a sparse-format operator."""
    if isinstance(A, DIAMatrix):
        return list(A.diags)
    if isinstance(A, HYBMatrix):
        return [A.ell.data, A.tail_vals]
    if isinstance(A, (ELLMatrix, CSRMatrix)):
        return [A.data]
    if isinstance(A, BSRMatrix):
        return [A.blocks]
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
