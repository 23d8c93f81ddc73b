"""ctypes bindings of the native host layer (port of
``iterativesolvers_tpu/native/__init__.py``; the source is this package's own
copy, ``itsolvers_native.cpp``).

COO -> CSR (a counting sort), level scheduling, CSR -> ELL packing,
MatrixMarket parsing, diagonal extraction, ILU(0), IC(0), reverse
Cuthill-McKee and greedy colouring are O(n) / O(nnz) host passes that are
interpreter-bound in pure Python.  Each entry point takes and returns numpy
arrays, as the JAX package's do.

The library is built at first use::

    g++ -O3 -march=native -shared -fPIC -o libitsolvers_native.so itsolvers_native.cpp

into ``iterativesolvers_tpu_torch/_build/native-<hash>/`` (the hash of the
source and the flags).  Concurrent builds (test workers) are safe: each
compiles to a temporary name and ``os.replace``s it into place.  A build or
load that fails is recorded (:func:`build_error`), and each entry point then
warns once and takes its numpy version.  The numpy versions (``_*_numpy``,
``_mm_read_python``) stay callable by name: the complex-valued paths use
them, and the tests hold the library against them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile
import warnings
from typing import Optional, Tuple

import numpy as np

__all__ = ["get_lib", "build_error", "coo_to_csr", "level_schedule",
           "csr_to_ell", "mm_read", "extract_diagonal", "greedy_coloring",
           "rcm_order", "ilu0", "ic0"]

_HERE = pathlib.Path(__file__).resolve().parent
SRC = _HERE / "itsolvers_native.cpp"
BUILD = _HERE.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)
_i64 = ctypes.c_int64

# restype, argtypes of every entry point of the source
_SIGNATURES = {
    "coo_to_csr": (_i64, [_i64p, _i64p, _f64p, _i64, _i64, _i64p, _i32p,
                          _f64p]),
    "level_schedule": (_i64, [_i64p, _i32p, _i64, ctypes.c_int32, _i64p]),
    "csr_to_ell": (None, [_i64p, _i32p, _f64p, _i64, _i64, _i32p, _f64p]),
    "mm_read": (_i64, [ctypes.c_char_p, _i64p, _i64p, _i64p, _f64p]),
    "extract_diagonal": (_i64, [_i64p, _i32p, _f64p, _i64, _f64p]),
    "ilu0": (_i64, [_i64p, _i32p, _f64p, _i64]),
    "ic0": (_i64, [_i64p, _i32p, _f64p, _i64]),
    "rcm_order": (_i64, [_i64p, _i32p, _i64, _i64p]),
    "greedy_coloring": (_i64, [_i64p, _i32p, _i64, _i64p]),
}


def library_path() -> pathlib.Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD / f"native-{h.hexdigest()[:16]}" / "libitsolvers_native.so"


def _build() -> pathlib.Path:
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile under a temporary name and rename, so that concurrent builds
    # and a build that was cut off never leave a library that looks finished
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ exited {proc.returncode}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def _load() -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    """(library, None) once built and loaded, else (None, why not)."""
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, RuntimeError) as e:
        return None, f"{type(e).__name__}: {e}"
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib, None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None if that failed."""
    return _load()[0]


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded; None if it was."""
    return _load()[1]


@functools.lru_cache(maxsize=None)
def _warn_fallback():
    warnings.warn(f"the native host library is not available "
                  f"({build_error()}); taking the numpy versions",
                  RuntimeWarning, stacklevel=3)


def _native():
    lib = get_lib()
    if lib is None:
        _warn_fallback()
    return lib


def _ptr(a, t):
    return a.ctypes.data_as(t)


def coo_to_csr(rows, cols, vals, n_rows: int):
    """Sorted CSR with duplicates summed, from COO: (indptr int64, indices
    int32, data float64)."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals64 = np.ascontiguousarray(vals, np.float64)
    # the C++ counting sort indexes raw buffers with these (count[row+1]++,
    # int32 cast of col) — out-of-range input must never reach it
    if rows.size and (int(rows.min()) < 0 or int(rows.max()) >= n_rows):
        raise ValueError(
            f"row indices out of range [0, {n_rows}): "
            f"[{rows.min()}, {rows.max()}]")
    if cols.size and (int(cols.min()) < 0 or int(cols.max()) >= 2**31):
        raise ValueError("column indices must fit int32 and be >= 0")
    lib = _native()
    if lib is None:
        return _coo_to_csr_numpy(rows, cols, vals64, n_rows)
    nnz = rows.size
    nnz_out = lib.coo_to_csr(_ptr(rows, _i64p), _ptr(cols, _i64p),
                             _ptr(vals64, _f64p), nnz, n_rows,
                             None, None, None)
    indptr = np.empty(n_rows + 1, np.int64)
    indices = np.empty(nnz_out, np.int32)
    data = np.empty(nnz_out, np.float64)
    lib.coo_to_csr(_ptr(rows, _i64p), _ptr(cols, _i64p), _ptr(vals64, _f64p),
                   nnz, n_rows, _ptr(indptr, _i64p), _ptr(indices, _i32p),
                   _ptr(data, _f64p))
    return indptr, indices, data


def _coo_to_csr_numpy(rows, cols, vals, n_rows):
    """numpy version of :func:`coo_to_csr`, generic in the values' dtype
    (duplicates summed in it)."""
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if rows.size:
        new = np.empty(rows.size, bool)
        new[0] = True
        new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        grp = np.cumsum(new) - 1
        merged = np.zeros(int(grp[-1]) + 1, vals.dtype)
        np.add.at(merged, grp, vals)
        rows, cols, vals = rows[new], cols[new], merged
    indptr = np.zeros(n_rows + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return np.cumsum(indptr), cols.astype(np.int32), vals


def level_schedule(indptr, indices, n: int, lower: bool) -> np.ndarray:
    """Dependency levels of a strict-triangular CSR: ``level[r]`` is one
    more than the largest level of the rows it depends on."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    lib = _native()
    if lib is None:
        return _level_schedule_numpy(indptr, indices, n, lower)
    level = np.zeros(n, np.int64)
    lib.level_schedule(_ptr(indptr, _i64p), _ptr(indices, _i32p), n,
                       1 if lower else 0, _ptr(level, _i64p))
    return level


def _level_schedule_numpy(indptr, indices, n, lower):
    level = np.zeros(n, np.int64)
    order = range(n) if lower else range(n - 1, -1, -1)
    for r in order:
        deps = indices[indptr[r]: indptr[r + 1]]
        if deps.size:
            level[r] = level[deps].max() + 1
    return level


def csr_to_ell(indptr, indices, data, n: int, width: int):
    """(cols int32 (n, width), data float64 (n, width)): the first
    ``width`` entries of each row, zero padded."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data64 = np.ascontiguousarray(data, np.float64)
    lib = _native()
    if lib is None:
        return _csr_to_ell_numpy(indptr, indices, data64, n, width)
    cols = np.empty((n, width), np.int32)
    out = np.empty((n, width), np.float64)
    lib.csr_to_ell(_ptr(indptr, _i64p), _ptr(indices, _i32p),
                   _ptr(data64, _f64p), n, width, _ptr(cols, _i32p),
                   _ptr(out, _f64p))
    return cols, out


def _csr_to_ell_numpy(indptr, indices, data, n, width):
    cols = np.zeros((n, width), np.int32)
    out = np.zeros((n, width), data.dtype)
    for r in range(n):
        lo, hi = indptr[r], indptr[r + 1]
        w = min(hi - lo, width)
        cols[r, :w] = indices[lo: lo + w]
        out[r, :w] = data[lo: lo + w]
    return cols, out


def mm_read(path) -> Tuple[Tuple[int, int], np.ndarray, np.ndarray,
                           np.ndarray]:
    """Parse a MatrixMarket coordinate file (real / integer / pattern;
    general / symmetric / skew-symmetric).  Returns ``((m, n), rows, cols,
    vals)`` in COO, 0-based, symmetry expanded (~ the loaders in
    benchmark/matrixmarket.jl)."""
    lib = _native()
    if lib is None:
        return _mm_read_python(path)
    name = os.fsencode(path)
    shape = np.zeros(2, np.int64)
    cnt = lib.mm_read(name, _ptr(shape, _i64p), None, None, None)
    if cnt < 0:
        raise ValueError(f"failed to parse MatrixMarket file {path} ({cnt})")
    rows = np.empty(cnt, np.int64)
    cols = np.empty(cnt, np.int64)
    vals = np.empty(cnt, np.float64)
    lib.mm_read(name, _ptr(shape, _i64p), _ptr(rows, _i64p),
                _ptr(cols, _i64p), _ptr(vals, _f64p))
    return (int(shape[0]), int(shape[1])), rows, cols, vals


def _mm_read_python(path):
    with open(path) as f:
        header = f.readline().split()
        if (len(header) < 5 or header[2] != "coordinate"
                or header[3] == "complex"):
            raise ValueError(f"unsupported MatrixMarket format in {path}")
        pattern = header[3] == "pattern"
        sym = header[4] in ("symmetric", "skew-symmetric")
        skew = header[4] == "skew-symmetric"
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        m, n, nnz = (int(t) for t in line.split())
        rows, cols, vals = [], [], []
        for _ in range(nnz):
            parts = f.readline().split()
            r, c = int(parts[0]) - 1, int(parts[1]) - 1
            v = 1.0 if pattern else float(parts[2])
            rows.append(r)
            cols.append(c)
            vals.append(v)
            if sym and r != c:
                rows.append(c)
                cols.append(r)
                vals.append(-v if skew else v)
    return (m, n), np.asarray(rows), np.asarray(cols), np.asarray(vals)


def extract_diagonal(indptr, indices, data, n: int):
    """(diag, first_bad_index or -1) — ~ DiagonalIndices' singular check."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data64 = np.ascontiguousarray(data, np.float64)
    lib = _native()
    if lib is None:
        return _extract_diagonal_numpy(indptr, indices, data64, n)
    diag = np.zeros(n, np.float64)
    bad = lib.extract_diagonal(_ptr(indptr, _i64p), _ptr(indices, _i32p),
                               _ptr(data64, _f64p), n, _ptr(diag, _f64p))
    return diag, int(bad)


def _extract_diagonal_numpy(indptr, indices, data, n):
    diag = np.zeros(n, np.float64)
    bad = -1
    for r in range(n):
        seg = indices[indptr[r]: indptr[r + 1]]
        hit = np.where(seg == r)[0]
        if hit.size:
            diag[r] = data[indptr[r] + hit[0]]
        if (hit.size == 0 or diag[r] == 0.0) and bad < 0:
            bad = r
    return diag, bad


def greedy_coloring(indptr, indices, n: int):
    """(colors (n,), ncolors): greedy multicolouring of the sparsity graph.
    Pass the symmetrized pattern for nonsymmetric matrices."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    lib = _native()
    if lib is None:
        return _greedy_coloring_numpy(indptr, indices, n)
    color = np.zeros(n, np.int64)
    nc = lib.greedy_coloring(_ptr(indptr, _i64p), _ptr(indices, _i32p), n,
                             _ptr(color, _i64p))
    return color, int(nc)


def _greedy_coloring_numpy(indptr, indices, n):
    color = np.zeros(n, np.int64)
    mark = np.full(n, -1, np.int64)
    nc = 0
    for r in range(n):
        for j in indices[indptr[r]: indptr[r + 1]]:
            if j < r:
                mark[color[j]] = r
        c = 0
        while c < n and mark[c] == r:
            c += 1
        color[r] = c
        nc = max(nc, c + 1)
    return color, nc


def rcm_order(indptr, indices, n: int):
    """(perm (n,), bandwidth): reverse Cuthill-McKee ordering of a SYMMETRIC
    sparsity pattern.  ``perm[k]`` is the old index placed at new position
    k; the bandwidth is the permuted pattern's half-bandwidth.  Pass the
    symmetrized pattern (A + A^T structure) for nonsymmetric matrices.  The
    numpy version is plain Cuthill-McKee from each component's
    lowest-degree vertex, without the library's pseudo-peripheral start, so
    the two may order differently."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    lib = _native()
    if lib is None:
        return _rcm_order_numpy(indptr, indices, n)
    perm = np.zeros(n, np.int64)
    bw = lib.rcm_order(_ptr(indptr, _i64p), _ptr(indices, _i32p), n,
                       _ptr(perm, _i64p))
    return perm, int(bw)


def _rcm_order_numpy(indptr, indices, n):
    # plain CM BFS (ascending degree), then reverse
    deg = np.diff(indptr)
    visited = np.zeros(n, bool)
    order = []
    for s in np.argsort(deg, kind="stable"):
        if visited[s]:
            continue
        queue = [int(s)]
        visited[s] = True
        head = 0
        while head < len(queue):
            u = queue[head]
            head += 1
            order.append(u)
            nbrs = [int(v) for v in indices[indptr[u]: indptr[u + 1]]
                    if v != u and v < n and not visited[v]]
            nbrs.sort(key=lambda v: deg[v])
            for v in nbrs:
                visited[v] = True
                queue.append(v)
    perm = np.asarray(order[::-1], np.int64)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    bw = 0
    for r in range(n):
        seg = indices[indptr[r]: indptr[r + 1]]
        if seg.size:
            bw = max(bw, int(np.abs(inv[r] - inv[seg]).max()))
    return perm, bw


def ilu0(indptr, indices, data, n: int):
    """ILU(0) on the CSR pattern (IKJ variant): a copy of ``data`` whose
    strict lower part is L (unit diagonal implied) and whose diagonal and
    strict upper part are U.  Raises ZeroDivisionError on a zero pivot or a
    structurally missing diagonal.  The library for real values; the numpy
    version for complex ones."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.asarray(data)
    # factors are not representable in narrowed value dtypes (int8 / bf16
    # from compress_values): factor in f64, return at float precision
    fdtype = np.result_type(data.dtype, np.float32)
    lib = None if np.iscomplexobj(data) else _native()
    if lib is None:
        return _ilu0_numpy(indptr, indices, data.astype(fdtype), n)
    out = np.ascontiguousarray(data, np.float64).copy()
    bad = lib.ilu0(_ptr(indptr, _i64p), _ptr(indices, _i32p),
                   _ptr(out, _f64p), n)
    if bad >= 0:
        raise ZeroDivisionError(f"ILU(0) zero/missing pivot at row {bad}")
    return out.astype(fdtype)


def _ilu0_numpy(indptr, indices, data, n):
    diag_ptr = np.full(n, -1, np.int64)
    for r in range(n):
        seg = indices[indptr[r]: indptr[r + 1]]
        hit = np.nonzero(seg == r)[0]
        if hit.size == 0:
            raise ZeroDivisionError(f"ILU(0) zero/missing pivot at row {r}")
        diag_ptr[r] = indptr[r] + int(hit[0])
    pos = np.full(n, -1, np.int64)
    for i in range(n):
        lo, hi = int(indptr[i]), int(indptr[i + 1])
        pos[indices[lo:hi]] = np.arange(lo, hi)
        for p in range(lo, int(diag_ptr[i])):
            k = int(indices[p])
            piv = data[diag_ptr[k]]
            if piv == 0:
                raise ZeroDivisionError(f"ILU(0) zero/missing pivot at row {k}")
            lik = data[p] / piv
            data[p] = lik
            q = slice(int(diag_ptr[k]) + 1, int(indptr[k + 1]))
            r2 = pos[indices[q]]
            ok = r2 >= 0
            data[r2[ok]] -= lik * data[q][ok]
        if data[diag_ptr[i]] == 0:
            raise ZeroDivisionError(f"ILU(0) zero/missing pivot at row {i}")
        pos[indices[lo:hi]] = -1
    return data


def ic0(indptr, indices, data, n: int):
    """IC(0) on a LOWER-triangular CSR pattern (row r holds columns <= r,
    sorted, diagonal last): the factor L with A ~= L L^H.  Raises
    ZeroDivisionError on breakdown (a non-positive pivot)."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.asarray(data)
    # see ilu0: never return factors in a narrowed value dtype
    fdtype = np.result_type(data.dtype, np.float32)
    lib = None if np.iscomplexobj(data) else _native()
    if lib is None:
        return _ic0_numpy(indptr, indices, data.astype(fdtype), n)
    out = np.ascontiguousarray(data, np.float64).copy()
    bad = lib.ic0(_ptr(indptr, _i64p), _ptr(indices, _i32p),
                  _ptr(out, _f64p), n)
    if bad >= 0:
        raise ZeroDivisionError(f"IC(0) breakdown at row {bad}")
    return out.astype(fdtype)


def _ic0_numpy(indptr, indices, data, n):
    pos = np.full(n, -1, np.int64)
    for i in range(n):
        lo, hi = int(indptr[i]), int(indptr[i + 1])
        if hi <= lo or indices[hi - 1] != i:
            raise ZeroDivisionError(f"IC(0) breakdown at row {i}")
        pos[indices[lo:hi]] = np.arange(lo, hi)
        for p in range(lo, hi - 1):
            k = int(indices[p])
            s = data[p]
            q = slice(int(indptr[k]), int(indptr[k + 1]) - 1)
            r2 = pos[indices[q]]
            ok = r2 >= 0
            s = s - np.sum(data[r2[ok]] * np.conj(data[q][ok]))
            data[p] = s / data[int(indptr[k + 1]) - 1]
        d = data[hi - 1] - np.sum(np.abs(data[lo:hi - 1]) ** 2)
        if np.real(d) <= 0:
            pos[indices[lo:hi]] = -1
            raise ZeroDivisionError(f"IC(0) breakdown at row {i}")
        data[hi - 1] = np.sqrt(np.real(d))
        pos[indices[lo:hi]] = -1
    return data
