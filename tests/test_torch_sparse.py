"""The port's stored sparse formats (CSR, ELL, HYB, BSR, and DIA's CSR form)
against the JAX package's, on the CPU, on the same numpy inputs.

Tolerances: products of f64 and complex128 matrices within 1e-12 relative
(||y_port - y_jax|| / ||y_jax||: the same products summed in another order
differ by a few ulps of the row sums; the real CSR product sums each row in
the JAX package's order, and is the same bits); f32 within 1e-5 relative (f32
ulp 6e-8 over rows of up to 17 terms).  Conversions, fixtures and every
integer array are equal; values built by the same numpy code are equal bit
for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterativesolvers_tpu as jits
from iterativesolvers_tpu.operators import sparse as jsparse
from iterativesolvers_tpu.utils import fixtures as jfix

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.utils import convert
from iterativesolvers_tpu_torch.utils import fixtures as pfix

from _torch_port import CPU, port_sparse, rel, sparse_spec, to_numpy

torch.set_num_threads(1)

DTYPES = [np.float32, np.float64, np.complex128]
SHAPES = [(13, 13), (17, 9), (9, 17)]


def dense_random(rng, n, m, dtype):
    a = rng.standard_normal((n, m))
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal((n, m))
    a[np.abs(a) < 0.7] = 0  # sparsify
    return a.astype(dtype)


def _vec(rng, shape, dtype):
    v = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(shape)
    return v.astype(dtype)


def _tol(dtype):
    return 1e-5 if np.dtype(dtype) == np.float32 else 1e-12


# each format built from a CSR matrix on both sides, by each package's own
# conversion (HYB with w = 1 so that a tail exists); "ell" and "hyb" take
# the adjoint product as a scatter, the others through their precomputed
# adjoint
FORMATS = {
    "csr": lambda A: A,
    "ell": lambda A: A.to_ell(),
    "ell_adjoint_chunked": lambda A: A.to_ell().with_adjoint(
    ).with_chunked_gather(4),
    "hyb": lambda A: A.to_hyb(row_width=1),
    "hyb_adjoint": lambda A: A.to_hyb(row_width=1).with_adjoint(),
}


def _check_products(jop, pop, rng, dtype):
    n, m = jop.shape
    x, y = _vec(rng, m, dtype), _vec(rng, n, dtype)
    X, Y = _vec(rng, (m, 3), dtype), _vec(rng, (3, m), dtype)
    tol = _tol(dtype)
    for name, got, want in (
            ("mv", pop.mv(torch.from_numpy(x)), jop.mv(x)),
            ("rmv", pop.rmv(torch.from_numpy(y)), jop.rmv(y)),
            ("mv (m, k)", pop.mv(torch.from_numpy(X)), jop.mv(X)),
            ("mv_rows", pop.mv_rows(torch.from_numpy(Y)), jop.mv_rows(Y))):
        assert rel(to_numpy(got), np.asarray(want)) <= tol, name
    np.testing.assert_array_equal(to_numpy(pop.to_dense()),
                                  np.asarray(jop.to_dense()))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_products_match_jax(fmt, dtype, shape):
    """mv, rmv, mv of (m, k) columns, mv_rows and to_dense of each format,
    the port's own conversion of the port's CSR against the JAX package's
    (as tests/test_sparse.py:29-44 against dense)."""
    rng = np.random.default_rng(7)
    dense = dense_random(rng, *shape, dtype)
    jop = FORMATS[fmt](jits.csr_from_dense(dense))
    pop = FORMATS[fmt](pits.csr_from_dense(dense, device=CPU))
    assert type(pop).__name__ == type(jop).__name__
    _check_products(jop, pop, rng, dtype)
    if fmt == "csr" and dtype != np.complex128:
        # each row summed in the JAX package's order: the same bits (a
        # complex product itself may round otherwise in XLA)
        x = _vec(rng, shape[1], dtype)
        np.testing.assert_array_equal(to_numpy(pop.mv(torch.from_numpy(x))),
                                      np.asarray(jop.mv(x)))


@pytest.mark.parametrize("bs", [1, 2, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bsr_products_match_jax(dtype, bs):
    rng = np.random.default_rng(bs)
    dense = dense_random(rng, 16, 12, dtype)
    jop = jsparse.BSRMatrix.from_csr(jits.csr_from_dense(dense), bs)
    pop = pits.BSRMatrix.from_csr(pits.csr_from_dense(dense, device=CPU), bs)
    _check_products(jop, pop, rng, dtype)
    assert pop.nnz == jop.nnz and pop.block_size == bs


@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_conversions_match_jax(dtype):
    """CSR -> DIA -> CSR, and dia_from_dense, against the JAX package's."""
    rng = np.random.default_rng(3)
    dense = dense_random(rng, 15, 15, dtype)
    jd = jits.csr_from_dense(dense).to_dia()
    pd = pits.csr_from_dense(dense, device=CPU).to_dia()
    assert pd.offsets == jd.offsets
    np.testing.assert_array_equal(to_numpy(pd.data), np.asarray(jd.data))
    _check_products(jd, pd, rng, dtype)
    for jc, pc in ((jd.to_csr(), pd.to_csr()),
                   (jits.dia_from_dense(dense).to_csr(),
                    pits.dia_from_dense(dense, device=CPU).to_csr())):
        for name in ("data", "indices", "indptr", "row_ids"):
            np.testing.assert_array_equal(to_numpy(getattr(pc, name)),
                                          np.asarray(getattr(jc, name)))


def _equal_arrays(p, j, names):
    for name in names:
        np.testing.assert_array_equal(to_numpy(getattr(p, name)),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)


CONVERSION_INPUTS = {
    "random_sparse 60x40": lambda m: m.random_sparse(60, 40, 0.08, seed=2),
    "sprand symmetrized + shift": lambda m: m.random_sparse(
        80, 80, 0.05, seed=5, symmetrize=True, shift=4.0),
    "laplace 2-D 6^2": lambda m: m.laplace_dia(6, 2).to_csr(),
}


class _PortFixtures:
    """The port's fixtures on the CPU, called as the JAX package's are."""

    @staticmethod
    def random_sparse(*a, **kw):
        return pfix.random_sparse(*a, device=CPU, **kw)

    @staticmethod
    def laplace_dia(*a, **kw):
        return pfix.laplace_dia(*a, device=CPU, **kw)


@pytest.mark.parametrize("key", list(CONVERSION_INPUTS))
def test_conversions_match_jax(key):
    """from_coo, to_ell, to_hyb (default w and w = 1), to_dia, BSR blocking,
    permute, rcm, diagonal and structure_stats: equal arrays."""
    build = CONVERSION_INPUTS[key]
    jA = build(jfix)
    pA = build(_PortFixtures)
    _equal_arrays(pA, jA, ("data", "indices", "indptr", "row_ids"))
    _equal_arrays(pA.to_ell(), jA.to_ell(), ("data", "cols"))
    for w in (None, 1):
        ph, jh = pA.to_hyb(row_width=w), jA.to_hyb(row_width=w)
        _equal_arrays(ph.ell, jh.ell, ("data", "cols"))
        _equal_arrays(ph, jh, ("tail_rows", "tail_cols", "tail_vals"))
    assert pA.structure_stats() == jA.structure_stats()
    n, m = jA.shape
    if n == m:
        pd, jd = pA.to_dia(), jA.to_dia()
        assert pd.offsets == jd.offsets
        np.testing.assert_array_equal(to_numpy(pd.data), np.asarray(jd.data))
        (pp, pbw), (jp, jbw) = pA.rcm(), jA.rcm()
        np.testing.assert_array_equal(pp, jp)
        assert pbw == jbw
        _equal_arrays(pA.permute(jp), jA.permute(jp),
                      ("data", "indices", "indptr"))
        (pdg, ppr), (jdg, jpr) = pA.diagonal(), jA.diagonal()
        np.testing.assert_array_equal(to_numpy(pdg), jdg)
        np.testing.assert_array_equal(to_numpy(ppr), jpr)
    for bs in (2, 4):
        if n % bs or m % bs:
            continue
        _equal_arrays(pits.BSRMatrix.from_csr(pA, bs),
                      jsparse.BSRMatrix.from_csr(jA, bs),
                      ("blocks", "block_cols", "block_row_ids"))


def test_from_coo_merges_duplicates_as_jax():
    rows = np.array([0, 2, 0, 2, 1, 0])
    cols = np.array([1, 0, 1, 0, 2, 0])
    for vals in (np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], np.float32),
                 np.array([1, 2j, 3, 4, 5j, 6], np.complex128)):
        jA = jits.CSRMatrix.from_coo(rows, cols, vals, (3, 3))
        pA = pits.CSRMatrix.from_coo(rows, cols, vals, (3, 3), device=CPU)
        assert pA.dtype == torch.from_numpy(vals).dtype
        _equal_arrays(pA, jA, ("data", "indices", "indptr", "row_ids"))


@pytest.mark.parametrize("rows,cols", [([0, 5], [0, 0]), ([0, 1], [0, 7]),
                                       ([-1], [0]), ([0], [-3])])
def test_from_coo_rejects_out_of_range_indices(rows, cols):
    """Hostile or malformed COO input (a bad MatrixMarket file) raises
    before it reaches the native counting sort, as in the JAX package."""
    vals = np.ones(len(rows))
    with pytest.raises(ValueError):
        jits.CSRMatrix.from_coo(rows, cols, vals, (3, 3))
    with pytest.raises(ValueError, match="out of range"):
        pits.CSRMatrix.from_coo(rows, cols, vals, (3, 3), device=CPU)


def _shuffled_band(rng, offsets, n=200):
    band = np.zeros((n, n))
    for off in offsets:
        idx = np.arange(max(0, -off), min(n, n - off))
        band[idx, idx + off] = rng.random(idx.size) + (3.0 if off == 0
                                                       else 0.0)
    shuf = rng.permutation(n)
    return band[np.ix_(shuf, shuf)]


def _block_tridiagonal(rng, n=128, bs=4):
    nb = n // bs
    dense = np.zeros((n, n))
    for bi in range(nb):
        for bj in (bi - 1, bi, bi + 1):
            if 0 <= bj < nb:
                dense[bi * bs:(bi + 1) * bs, bj * bs:(bj + 1) * bs] = (
                    rng.random((bs, bs)) + 0.1)
    return dense


def _coo_dense(rows, cols, vals, n):
    dense = np.zeros((n, n), vals.dtype)
    np.add.at(dense, (rows, cols), vals)
    return dense


# the structures of tests/test_sparse.py:301-368, as (dense matrix or JAX
# CSR builder, auto_format keywords)
AUTO_FORMAT_CASES = {
    "laplace 2-D 12^2": (lambda rng: np.asarray(
        jfix.laplace_dia(12, 2).to_dense()), {}),
    "random_sparse 256": (lambda rng: np.asarray(
        jfix.random_sparse(256, 256, 0.02, seed=1).to_dense()), {}),
    "shuffled tridiagonal": (lambda rng: _shuffled_band(rng, (-1, 0, 1)), {}),
    "shuffled pentadiagonal": (
        lambda rng: _shuffled_band(rng, (-2, -1, 0, 1, 2)), {}),
    "block tridiagonal, no RCM": (_block_tridiagonal, {"try_rcm": False}),
    "block tridiagonal": (_block_tridiagonal, {}),
    "rectangular sprand": (lambda rng: np.asarray(
        jfix.random_sparse(96, 64, 0.05, seed=4).to_dense()), {}),
    # 27 diagonals: a DIA pick past one launch of the DIA kernel
    "27-point stencil 6^3": (lambda rng: _coo_dense(
        *pfix.stencil27_coo(6)), {}),
}


@pytest.mark.parametrize("case", list(AUTO_FORMAT_CASES))
def test_auto_format_matches_jax(case):
    """The same class, the same perm (None or equal) and the same operator
    as the JAX package's auto_format, on the same matrix."""
    build, kw = AUTO_FORMAT_CASES[case]
    dense = build(np.random.default_rng(11))
    jop, jperm = jits.csr_from_dense(dense).auto_format(**kw)
    pop, pperm = pits.csr_from_dense(dense, device=CPU).auto_format(**kw)
    assert type(pop).__name__ == type(jop).__name__
    assert (pperm is None) == (jperm is None)
    if jperm is not None:
        np.testing.assert_array_equal(pperm, jperm)
    np.testing.assert_array_equal(to_numpy(pop.to_dense()),
                                  np.asarray(jop.to_dense()))


COMPRESS_CASES = {
    # integer values (int8), bf16-exact values, values exact in neither
    "integer": lambda: np.asarray(jfix.laplace_dia(5, 2).to_dense()),
    "bf16": lambda: np.asarray(jfix.laplace_dia(5, 2).to_dense()) * 0.375,
    "neither": lambda: np.asarray(jfix.random_sparse(
        25, 25, 0.2, seed=3).to_dense()),
}


def _compress_format(fmt, A, pkg):
    if fmt == "bsr":
        return pkg.BSRMatrix.from_csr(A, 5)
    return {"csr": lambda: A, "ell": A.to_ell,
            "hyb": lambda: A.to_hyb(row_width=2), "dia": A.to_dia}[fmt]()


@pytest.mark.parametrize("fmt", ["csr", "ell", "hyb", "bsr", "dia"])
@pytest.mark.parametrize("case", list(COMPRESS_CASES))
def test_compress_values_matches_jax(case, fmt):
    """compress_values picks the JAX package's dtype on every format, and
    the compressed products agree with the JAX package's."""
    dense = COMPRESS_CASES[case]()
    jop = _compress_format(fmt, jits.csr_from_dense(dense), jsparse)
    pop = _compress_format(fmt, pits.csr_from_dense(dense, device=CPU), pits)
    jc, pc = jits.compress_values(jop), pits.compress_values(pop)
    assert str(pc.dtype).split(".")[-1] == str(jc.dtype)
    for dt in (np.int8, "bfloat16"):
        assert pits.values_representable(pop, dt) == \
            jits.values_representable(jop, dt)
    x = np.random.default_rng(1).standard_normal(25).astype(np.float32)
    assert rel(to_numpy(pc.mv(torch.from_numpy(x))),
               np.asarray(jc.mv(x))) <= 1e-6


@pytest.mark.parametrize("fmt", ["csr", "ell", "hyb", "gradient"])
def test_gershgorin_bounds_via_csr_match_jax(fmt):
    """The CSR route of gershgorin_bounds: equal to 1e-12."""
    if fmt == "gradient":
        jop = jits.GradientOperator((4, 5), dtype=np.float64)
        pop = pits.GradientOperator((4, 5), dtype=torch.float64, device=CPU)
    else:
        A = jfix.random_sparse(40, 40, 0.1, seed=6, symmetrize=True,
                               shift=3.0)
        jop = FORMATS[fmt](A)
        pop = port_sparse(jop)
    np.testing.assert_allclose(pits.gershgorin_bounds(pop),
                               jits.gershgorin_bounds(jop), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("dims", [(5,), (3, 4), (3, 2, 4)])
def test_gradient_to_csr_matches_jax(dims):
    jc = jits.GradientOperator(dims, dtype=np.float32).to_csr()
    pc = pits.GradientOperator(dims, dtype=torch.float32, device=CPU).to_csr()
    assert pc.dtype == torch.float32 and pc.shape == jc.shape
    _equal_arrays(pc, jc, ("data", "indices", "indptr", "row_ids"))


def _sprand():
    return jfix.random_sparse(30, 20, 0.15, seed=8)


CARRY_INPUTS = {
    "csr": _sprand,
    "ell": lambda: _sprand().to_ell(),
    "ell with adjoint": lambda: _sprand().to_ell().with_adjoint(),
    "hyb": lambda: _sprand().to_hyb(row_width=1),
    "hyb with adjoint": lambda: _sprand().to_hyb(row_width=1).with_adjoint(),
    "bsr": lambda: jsparse.BSRMatrix.from_csr(_sprand(), 5),
    "csr bf16": lambda: jits.compress_values(
        jfix.laplace_dia(5, 2).to_csr(), jnp.bfloat16),
}


@pytest.mark.parametrize("kind", list(CARRY_INPUTS))
def test_carry_across_matches_jax(kind):
    """operator_from_arrays builds each format from the JAX operator's
    numpy arrays: the same arrays (adjoints included), the same products;
    bf16 values stay bf16.  With a mesh an ELL matrix is the
    ``RowShardedELLOperator``; the other formats have no row-sharded
    form."""
    jop = CARRY_INPUTS[kind]()
    spec = sparse_spec(jop)
    pop = convert.operator_from_arrays(spec, device=CPU)
    assert type(pop).__name__ == type(jop).__name__
    if kind == "csr bf16":
        assert pop.dtype == torch.bfloat16 and str(jop.dtype) == "bfloat16"
    if "adjoint" in kind:
        assert pop.adj is not None
        inner = pop.adj.ell if kind.startswith("hyb") else pop.adj
        jinner = jop.adj.ell if kind.startswith("hyb") else jop.adj
        _equal_arrays(inner, jinner, ("data", "cols"))
    _check_products(jop, pop, np.random.default_rng(2), np.float64)
    if kind.startswith("ell"):
        # an ELL matrix has a row-sharded form: on a one-rank mesh it is the
        # one-device operator's products
        from iterativesolvers_tpu_torch.parallel import (RowMesh,
                                                         RowShardedELLOperator)

        mop = convert.operator_from_arrays(spec, mesh=RowMesh(0, 1, CPU,
                                                              "gloo"))
        assert isinstance(mop, RowShardedELLOperator)
        assert (mop.local_adj is None) == ("adjoint" not in kind)
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            pop.shape[1]))
        y = torch.from_numpy(np.random.default_rng(4).standard_normal(
            pop.shape[0]))
        assert torch.equal(mop.mv(x), pop.mv(x))
        torch.testing.assert_close(mop.rmv(y), pop.rmv(y), rtol=1e-14,
                                   atol=1e-14)
    else:
        with pytest.raises(ValueError, match="row-sharded"):
            convert.operator_from_arrays(spec, mesh=object())


@pytest.mark.parametrize("fixture", ["laplace_matrix_coo", "random_sparse",
                                     "random_sparse symmetrized",
                                     "variable_diffusion"])
def test_fixtures_match_jax(fixture):
    """The host fixtures with the JAX package's generator calls: equal
    arrays, bit for bit."""
    if fixture == "laplace_matrix_coo":
        for dt in (np.float32, np.float64):
            for p, j in zip(pfix.laplace_matrix_coo(6, 3, dtype=dt),
                            jfix.laplace_matrix_coo(6, 3, dtype=dt)):
                np.testing.assert_array_equal(np.asarray(p), np.asarray(j))
                assert np.asarray(p).dtype == np.asarray(j).dtype
    elif fixture.startswith("random_sparse"):
        kw = (dict(symmetrize=True, shift=4.0) if "symmetrized" in fixture
              else {})
        m = 300 if kw else 200
        j = jfix.random_sparse(300, m, 0.01, seed=1, dtype=np.float32, **kw)
        p = pfix.random_sparse(300, m, 0.01, seed=1, dtype=np.float32,
                               device=CPU, **kw)
        assert p.dtype == torch.float32
        _equal_arrays(p, j, ("data", "indices", "indptr", "row_ids"))
    else:
        kw = dict(contrast=1e3, aniso=(1.0, 2.0, 10.0), smooth=2, seed=4)
        j = jfix.variable_diffusion(5, 3, **kw)
        p = pfix.variable_diffusion(5, 3, device=CPU, **kw)
        assert p.offsets == j.offsets
        np.testing.assert_array_equal(to_numpy(p.data), np.asarray(j.data))


def test_csr_mv_segments_sorted_rows_in_order():
    """Empty rows give 0, and the CSR product of a matrix with rows of
    every length from 0 to 9 sums each row as the JAX package does (the same
    bits)."""
    rng = np.random.default_rng(4)
    rows = np.repeat(np.arange(10), np.arange(10))
    cols = rng.integers(0, 12, rows.size)
    vals = rng.standard_normal(rows.size)
    jA = jits.CSRMatrix.from_coo(rows, cols, vals, (10, 12))
    pA = pits.CSRMatrix.from_coo(rows, cols, vals, (10, 12), device=CPU)
    x = rng.standard_normal(12)
    y = to_numpy(pA.mv(torch.from_numpy(x)))
    assert y[0] == 0.0
    np.testing.assert_array_equal(y, np.asarray(jA.mv(x)))


def test_unsorted_tails_and_block_rows_are_sorted():
    """A HYB tail or BSR blocks given out of row order give the products of
    the same matrix in row order."""
    rng = np.random.default_rng(9)
    A = jfix.random_sparse(20, 20, 0.2, seed=9).to_hyb(row_width=1)
    spec = sparse_spec(A)
    order = rng.permutation(A.tail_nnz)
    for k in ("tail_rows", "tail_cols", "tail_vals"):
        spec[k] = spec[k][order]
    pop = convert.operator_from_arrays(spec, device=CPU)
    x = rng.standard_normal(20)
    assert rel(to_numpy(pop.mv(torch.from_numpy(x))), np.asarray(A.mv(x))) \
        <= 1e-12
    B = jsparse.BSRMatrix.from_csr(jfix.random_sparse(20, 20, 0.2, seed=9), 4)
    spec = sparse_spec(B)
    order = rng.permutation(spec["blocks"].shape[0])
    for k in ("blocks", "block_cols", "block_row_ids"):
        spec[k] = spec[k][order]
    pop = convert.operator_from_arrays(spec, device=CPU)
    assert rel(to_numpy(pop.mv(torch.from_numpy(x))), np.asarray(B.mv(x))) \
        <= 1e-12
