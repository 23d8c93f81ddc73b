"""Matrix I/O — the MatrixMarket loader (port of
``iterativesolvers_tpu/utils/io.py``).

The reference's benchmark suite loads NIST / SuiteSparse matrices through
MatrixMarket.jl (benchmark/matrixmarket.jl:1-32).  Here the parse runs in
the native host layer (``native.mm_read``, ctypes), with its Python version
where the library could not be built.
"""

from __future__ import annotations

import numpy as np

from ..native import mm_read
from ..operators.sparse import CSRMatrix

__all__ = ["load_matrix_market"]


def load_matrix_market(path, dtype=np.float64, device="cuda") -> CSRMatrix:
    """Read a MatrixMarket coordinate file into a :class:`CSRMatrix` on
    ``device`` (real / integer / pattern fields; general / symmetric /
    skew-symmetric)."""
    shape, rows, cols, vals = mm_read(path)
    return CSRMatrix.from_coo(rows, cols, vals.astype(dtype), shape,
                              device=device)
