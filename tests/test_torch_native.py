"""The port's native host layer (``iterativesolvers_tpu_torch/native``, its
own copy of the C++ source, built by g++ at first use) against its numpy
versions and against the JAX package's native layer, on the same numpy
inputs.  Every output is equal: integer arrays, and values computed by the
same code in f64 (the library's and the numpy versions' float outputs agree
to 1e-12 relative where they sum in another order: ILU(0), IC(0)).
"""

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from iterativesolvers_tpu import native as jnative

from iterativesolvers_tpu_torch import native as pnative


def _csr(dense):
    """(indptr, indices, data) of a dense matrix's nonzeros, by numpy."""
    rows, cols = np.nonzero(dense)
    indptr = np.zeros(dense.shape[0] + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return np.cumsum(indptr), cols.astype(np.int32), dense[rows, cols]


def _jax_fallback(monkeypatch, fn, *args):
    """The JAX package's entry point with its library taken away (its
    numpy fallback)."""
    with monkeypatch.context() as m:
        m.setattr(jnative, "get_lib", lambda: None)
        return fn(*args)


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _equal(u, v)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_native_library_builds():
    """The library is built from the port's own source into the port's
    build directory and loads; no build error is recorded."""
    assert pnative.get_lib() is not None, pnative.build_error()
    assert pnative.build_error() is None
    path = pnative.library_path()
    assert path.is_file()
    assert path.parent.parent == pathlib.Path(pnative.__file__).resolve(
        ).parent.parent / "_build"
    assert pnative.SRC.parent == pathlib.Path(pnative.__file__).resolve(
        ).parent


def _inputs(rng):
    n = 40
    rows = rng.integers(0, n, 300)
    cols = rng.integers(0, n, 300)
    vals = rng.standard_normal(300)
    T = np.tril(rng.random((n, n)), -1)
    T[T < 0.8] = 0.0
    M = rng.random((n, n))
    M[M < 0.75] = 0.0
    sym = M + M.T
    spd = sym + np.diag(sym.sum(axis=1) + 1.0)
    return n, rows, cols, vals, T, M, sym, spd


ENTRY_POINTS = {
    "coo_to_csr": lambda n, r, c, v, T, M, S, P: (r, c, v, n),
    "level_schedule lower": lambda n, r, c, v, T, M, S, P: (
        *_csr(T)[:2], n, True),
    "level_schedule upper": lambda n, r, c, v, T, M, S, P: (
        *_csr(T.T.copy())[:2], n, False),
    "csr_to_ell full": lambda n, r, c, v, T, M, S, P: (
        *_csr(M), n, int(np.diff(_csr(M)[0]).max())),
    "csr_to_ell truncated": lambda n, r, c, v, T, M, S, P: (*_csr(M), n, 3),
    "extract_diagonal": lambda n, r, c, v, T, M, S, P: (*_csr(P), n),
    "extract_diagonal missing": lambda n, r, c, v, T, M, S, P: (*_csr(M), n),
    "greedy_coloring": lambda n, r, c, v, T, M, S, P: (*_csr(S)[:2], n),
    "rcm_order": lambda n, r, c, v, T, M, S, P: (*_csr(S)[:2], n),
    "ilu0": lambda n, r, c, v, T, M, S, P: (*_csr(P + np.triu(M, 1)), n),
    "ic0": lambda n, r, c, v, T, M, S, P: (*_csr(np.tril(P)), n),
}

# the numpy version of each entry point in the port
NUMPY = {
    "coo_to_csr": lambda r, c, v, n: pnative._coo_to_csr_numpy(
        np.asarray(r, np.int64), np.asarray(c, np.int64), v, n),
    "level_schedule": pnative._level_schedule_numpy,
    "csr_to_ell": lambda p, i, d, n, w: pnative._csr_to_ell_numpy(
        p, i, np.asarray(d, np.float64), n, w),
    "extract_diagonal": pnative._extract_diagonal_numpy,
    "greedy_coloring": pnative._greedy_coloring_numpy,
    "rcm_order": pnative._rcm_order_numpy,
    "ilu0": lambda p, i, d, n: pnative._ilu0_numpy(p, i, d.copy(), n),
    "ic0": lambda p, i, d, n: pnative._ic0_numpy(p, i, d.copy(), n),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_matches_numpy_and_jax(entry, monkeypatch):
    """The port's library, the port's numpy version, the JAX package's
    library and the JAX package's numpy fallback give the same output
    (rcm_order: the numpy versions order by plain Cuthill-McKee, without
    the library's pseudo-peripheral start, so each is held to its
    counterpart)."""
    name = entry.split()[0]
    args = ENTRY_POINTS[entry](*_inputs(np.random.default_rng(5)))
    port = getattr(pnative, name)(*args)
    jax_native = getattr(jnative, name)(*args)
    jax_numpy = _jax_fallback(monkeypatch, getattr(jnative, name), *args)
    port_numpy = NUMPY[name](*args)
    _equal(port, jax_native)
    if name in ("ilu0", "ic0"):
        # the library factors in f64, the numpy versions in the values'
        # dtype, each in its own order of the same sums
        np.testing.assert_allclose(port_numpy, port, rtol=1e-12)
        _equal(port_numpy, jax_numpy)
    elif name == "rcm_order":
        _equal(port_numpy, jax_numpy)
    else:
        _equal(port_numpy, port)
        _equal(jax_numpy, port)
    if entry == "extract_diagonal missing":
        assert port[1] >= 0


def test_complex_factorizations_take_the_numpy_versions():
    """ILU(0) / IC(0) of complex values go through the numpy versions, as
    in the JAX package."""
    rng = np.random.default_rng(2)
    n = 12
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A[np.abs(A) < 1.2] = 0
    H = A @ A.conj().T + n * np.eye(n)
    for fn, M in ((pnative.ilu0, A + 4 * n * np.eye(n)),
                  (pnative.ic0, np.tril(H))):
        args = (*_csr(M), n)
        _equal(fn(*args), getattr(jnative, fn.__name__)(*args))


def test_factorization_breakdowns_raise():
    n = 4
    A = np.eye(n)
    A[2, 2] = 0.0
    A[2, 1] = 1.0
    with pytest.raises(ZeroDivisionError, match="row 2"):
        pnative.ilu0(*_csr(A), n)
    with pytest.raises(ZeroDivisionError, match="row 2"):
        pnative.ic0(*_csr(np.tril(A - 2 * np.eye(n) * (np.arange(n) == 2))),
                    n)


@pytest.mark.parametrize("rows,cols", [([0, 7], [0, 0]), ([-1], [0]),
                                       ([0], [-2]), ([0], [2**31])])
def test_hostile_indices_never_reach_the_counting_sort(rows, cols):
    with pytest.raises(ValueError):
        pnative.coo_to_csr(rows, cols, np.ones(len(rows)), 5)


@pytest.mark.parametrize("field,symmetry", [
    ("real", "general"), ("real", "symmetric"), ("real", "skew-symmetric"),
    ("pattern", "general"), ("integer", "symmetric")])
def test_mm_read_matches_python_and_jax(tmp_path, field, symmetry):
    rng = np.random.default_rng(3)
    n, nnz = 12, 30
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.integers(-9, 9, nnz) if field == "integer" else rng.random(
        nnz).round(6)
    if symmetry != "general":
        keep = rows > cols if symmetry == "skew-symmetric" else rows >= cols
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    path = tmp_path / "m.mtx"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        f.write("% comment\n%\n")
        f.write(f"{n} {n} {rows.size}\n")
        for r, c, v in zip(rows, cols, vals):
            f.write(f"{r + 1} {c + 1}" + ("" if field == "pattern"
                                          else f" {v}") + "\n")
    got = pnative.mm_read(str(path))
    _equal(got[0], (n, n))
    for want in (pnative._mm_read_python(str(path)),
                 jnative.mm_read(str(path))):
        _equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, np.asarray(b, a.dtype))


def test_mm_read_rejects_complex_and_missing_files(tmp_path):
    path = tmp_path / "c.mtx"
    path.write_text("%%MatrixMarket matrix coordinate complex general\n"
                    "1 1 1\n1 1 1.0 2.0\n")
    for p in (str(path), str(tmp_path / "missing.mtx")):
        with pytest.raises(ValueError):
            pnative.mm_read(p)


_BUILDER = textwrap.dedent("""
    import importlib.util, pathlib, sys
    spec = importlib.util.spec_from_file_location("native_copy", sys.argv[1])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.BUILD = pathlib.Path(sys.argv[2])
    lib = mod.get_lib()
    assert lib is not None, mod.build_error()
    print(mod.library_path())
""")


def test_concurrent_builds_leave_one_whole_library(tmp_path):
    """Four processes that build at once into an empty build directory
    (as test workers do) each load a whole library, and no temporary file
    is left beside it."""
    src = pathlib.Path(pnative.__file__)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(src),
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    files = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert [p.name for p in files] == ["libitsolvers_native.so"]


def test_failed_build_is_recorded_and_reported(tmp_path, monkeypatch):
    """A source that does not compile: get_lib() is None, build_error()
    says why, and an entry point warns and takes its numpy version."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pnative, "SRC", bad)
    monkeypatch.setattr(pnative, "BUILD", tmp_path / "build")
    pnative._load.cache_clear()
    pnative._warn_fallback.cache_clear()
    try:
        assert pnative.get_lib() is None
        assert "g++" in pnative.build_error()
        with pytest.warns(RuntimeWarning, match="numpy versions"):
            got = pnative.coo_to_csr([1, 0, 1], [0, 1, 0], [1.0, 2.0, 3.0], 2)
        _equal(got, (np.array([0, 1, 2]), np.array([1, 0], np.int32),
                     np.array([2.0, 4.0])))
    finally:
        monkeypatch.undo()
        pnative._load.cache_clear()
        pnative._warn_fallback.cache_clear()
    assert pnative.get_lib() is not None
