"""The port's row-panel products (``mv_rows`` on the five operator classes),
``ScaledIdentityPlusOperator``, ``GradientOperator``, block CG, LSQR and
LSMR against the JAX package's, on the CPU, on the same inputs (numpy,
seeded).

Tolerances: products rtol 1e-12 in f64 (the port's stencil sums its terms in
another order than the JAX ``_apply``) and, in f32, rtol 1e-6 with atol
1e-6 * max|y|; each row of ``mv_rows`` is the same bits as the port's ``mv``
of that row.  Solves: f64 (and complex128) equal step and product counts
and istop; block CG's residual series and x within 1e-10 relative; LSQR's
and LSMR's history series and x within 1e-10 relative plus four times the
JAX package's own spread, its answer for b (1 + 1e-15) against its answer
for b (late in a solve their :anorm and :cnorm series are quotients of
quantities at their rounding floor, which that change of b alone moves by
up to ~20% on the dense case, and the last :resnorm entries, x and a
complex solve move by up to a few 1e-10).  f32 steps within 2 and x within
1e-4 relative.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterativesolvers_tpu as jits
from iterativesolvers_tpu.operators import linear_operator as jlo
from iterativesolvers_tpu.utils import fixtures as jfix

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.operators import linear_operator as plo
from iterativesolvers_tpu_torch.utils import convert

from _torch_port import CPU, port_dia, port_stencil, rel, to_numpy, to_torch

torch.set_num_threads(1)

F64, F32, C128 = np.float64, np.float32, np.complex128


def _close(got, want, dtype):
    want = np.asarray(want)
    if np.dtype(dtype) in (np.dtype(F64), np.dtype(C128)):
        np.testing.assert_allclose(to_numpy(got), want, rtol=1e-12,
                                   atol=1e-13 * np.abs(want).max())
    else:
        np.testing.assert_allclose(to_numpy(got), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def _panel(rng, k, n, dtype):
    X = rng.standard_normal((k, n))
    if np.issubdtype(dtype, np.complexfloating):
        X = X + 1j * rng.standard_normal((k, n))
    return X.astype(dtype)


def _gradient(dims, dtype):
    """The JAX and the port's GradientOperator of one grid."""
    return (jits.GradientOperator(dims, dtype=dtype),
            convert.operator_from_arrays(
                {"kind": "gradient", "dims": dims,
                 "dtype": np.dtype(dtype).name}, device=CPU))


# ---- mv_rows ---------------------------------------------------------------

def _operators(rng, dtype):
    """name -> (JAX operator, port operator) over the five classes."""
    n = 64
    M = _panel(rng, n, n, dtype)
    St = jits.laplacian(4, 3, dtype=dtype)
    A = jfix.laplace_dia(8, 2, dtype=dtype)
    return {
        "LinearOperator (adjoint of a matrix)": (
            jlo.AdjointOperator(jlo.MatrixOperator(jnp.asarray(M))),
            plo.AdjointOperator(plo.MatrixOperator(to_torch(M)))),
        "MatrixOperator": (jlo.MatrixOperator(jnp.asarray(M)),
                           plo.MatrixOperator(to_torch(M))),
        "FunctionOperator": (
            jlo.FunctionOperator(lambda v: jnp.asarray(M) @ v, (n, n),
                                 dtype),
            plo.FunctionOperator(lambda v: to_torch(M) @ v, (n, n), dtype,
                                 device=CPU)),
        "DIAMatrix": (A, port_dia(A)),
        "StencilOperator": (St, port_stencil(St)),
    }


@pytest.mark.parametrize("dtype", [F64, F32])
def test_mv_rows_matches_jax_and_mv_row_by_row(rng, dtype):
    """All five operator classes: ``mv_rows`` of a (5, n) panel against the
    JAX package's, and each row the port's ``mv`` of it: the same bits on
    the DIA, stencil and function operators (the f32 DIA and stencil rows
    through the kernels' plain versions, the CPU's form of the kernels'
    routes), within rounding where a matrix product takes the panel in one
    GEMM."""
    for name, (J, P) in _operators(rng, dtype).items():
        X = _panel(rng, 5, J.shape[1], dtype)
        got = P.mv_rows(to_torch(X))
        assert tuple(got.shape) == (5, J.shape[0]), name
        _close(got, J.mv_rows(jnp.asarray(X)), dtype)
        for i in range(5):
            row = P.mv(to_torch(X[i]))
            if "Matrix" in name or "matrix" in name:
                _close(got[i], to_numpy(row), dtype)
            else:
                assert torch.equal(got[i], row), (name, i)


@pytest.mark.parametrize("diag", ["float32", "bfloat16", "int8"])
def test_dia_mv_rows_compressed_diagonals(rng, diag):
    """f32 rows over f32 / bf16 / int8 diagonals: the kernel's route (its
    plain version on the CPU), each row the same bits as ``mv``, and equal
    to the JAX package's vmapped product within the f32 tolerance."""
    A = jits.compress_values(jfix.laplace_dia(8, 3, dtype=F32),
                             getattr(jnp, diag))
    P = port_dia(A)
    assert str(P.dtype) == f"torch.{diag}"
    X = _panel(rng, 4, A.shape[0], F32)
    got = P.mv_rows(to_torch(X))
    _close(got, A.mv_rows(jnp.asarray(X)), F32)
    for i in range(4):
        assert torch.equal(got[i], P.mv(to_torch(X[i])))


@pytest.mark.parametrize("dtype", [F32, "bfloat16", C128])
def test_stencil_mv_rows_dtypes(rng, dtype):
    """bf16 rows take the kernel's route (y in bf16, as ``mv``); complex
    rows the plain sum.  Each row the same bits as ``mv``."""
    if dtype == "bfloat16":
        St = jits.laplacian(6, 3, dtype=F32)
        X = to_torch(_panel(rng, 3, St.n, F32)).to(torch.bfloat16)
        want = St.mv_rows(jnp.asarray(X.float().numpy(), jnp.bfloat16))
    else:
        St = jits.laplacian(6, 3, dtype=dtype)
        X = to_torch(_panel(rng, 3, St.n, dtype))
        want = St.mv_rows(jnp.asarray(X.numpy()))
    P = port_stencil(St)
    got = P.mv_rows(X)
    assert got.dtype == X.dtype
    if dtype == "bfloat16":
        np.testing.assert_allclose(to_numpy(got),
                                   np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)
    else:
        _close(got, want, dtype)
    for i in range(3):
        assert torch.equal(got[i], P.mv(X[i]))


def test_mv_rows_kernel_route_is_row_by_row_on_cpu(rng):
    """The wrappers' panel form on a CPU tensor is the plain version of the
    panel's columns: no kernel is launched (their counters stay) and the
    rows match the 1-D plain product bit for bit."""
    from iterativesolvers_tpu_torch.ops import cuda_spmv, cuda_stencil

    St = port_stencil(jits.laplacian(5, 3, dtype=F32))
    A = port_dia(jfix.laplace_dia(5, 3, dtype=F32))
    X = to_torch(_panel(rng, 3, 125, F32))
    before = (cuda_stencil.stencil_apply.launches, cuda_spmv.dia_spmv.launches)
    Ys = cuda_stencil.stencil_apply_rows(St.n, St.center, St.terms,
                                         St.coeffs, X)
    Yd = cuda_spmv.dia_spmv_rows(A.diags, A.offsets, X)
    assert (cuda_stencil.stencil_apply.launches,
            cuda_spmv.dia_spmv.launches) == before
    for i in range(3):
        assert torch.equal(Ys[i], cuda_stencil.stencil_apply_plain(
            St.n, St.center, St.terms, St.coeffs, X[i]))
        assert torch.equal(Yd[i], cuda_spmv.dia_spmv_plain(A.diags,
                                                           A.offsets, X[i]))
    with pytest.raises(ValueError, match="shape"):
        cuda_stencil.stencil_apply_rows(St.n, St.center, St.terms, St.coeffs,
                                        X[:, :100])


@pytest.mark.parametrize("layout", ["columns", "padded rows"])
def test_mv_rows_takes_strided_panels(rng, layout):
    """A (k, n) panel that is a view (the transpose of an (n, k) block, or
    rows of a padded buffer) gives every row the same bits as ``mv`` of it,
    on the stencil and DIA routes."""
    St = port_stencil(jits.laplacian(5, 3, dtype=F32))
    A = port_dia(jfix.laplace_dia(5, 3, dtype=F32))
    X = to_torch(_panel(rng, 3, 125, F32))
    if layout == "columns":
        V = X.T.contiguous().T
    else:
        V = torch.zeros(3, 128)[:, :125]
        V.copy_(X)
    for op in (St, A):
        Y = op.mv_rows(V)
        assert Y.shape == (3, 125)
        for i in range(3):
            assert torch.equal(Y[i], op.mv(X[i]))


@pytest.mark.parametrize("dtype", [F64, C128])
def test_preconditioner_ldiv_rows(rng, dtype):
    """ldiv_rows of the identity, diagonal, dense and function
    preconditioners is ldiv row by row."""
    n = 30
    d = rng.random(n) + 1.0
    M = np.eye(n) * 4 + 0.1 * rng.standard_normal((n, n))
    X = to_torch(_panel(rng, 3, n, dtype))
    for P in (pits.IdentityPreconditioner(),
              pits.DiagonalPreconditioner(to_torch(d), device=CPU),
              pits.DensePreconditioner(to_torch(M), device=CPU),
              pits.FunctionPreconditioner(lambda v: 2.0 * v)):
        got = P.ldiv_rows(X)
        for i in range(3):
            torch.testing.assert_close(got[i], P.ldiv(X[i]), rtol=1e-14,
                                       atol=1e-14)


# ---- ScaledIdentityPlusOperator and GradientOperator -------------------------

@pytest.mark.parametrize("sigma", [0.75, 0.5 - 1.25j])
def test_scaled_identity_plus_matches_jax(rng, sigma):
    """(A + sigma I): mv, rmv with conj(sigma), and mv_rows, over a DIA
    matrix, built in both packages from ``operator_from_arrays``' spec."""
    A = jfix.advection_diffusion(4, dtype=F64)[0]
    J = jlo.ScaledIdentityPlusOperator(A, sigma)
    P = convert.operator_from_arrays(
        {"kind": "scaled_identity_plus", "sigma": sigma,
         "inner": {"kind": "dia", "diags": [np.asarray(d) for d in A.diags],
                   "offsets": A.offsets, "shape": A.shape}}, device=CPU)
    assert isinstance(P, plo.ScaledIdentityPlusOperator)
    assert P.shape == J.shape and P.device == torch.device(CPU)
    x = _panel(rng, 1, A.shape[0], C128)[0]
    X = _panel(rng, 3, A.shape[0], C128)
    _close(P.mv(to_torch(x)), J.mv(jnp.asarray(x)), C128)
    _close(P.rmv(to_torch(x)), J.rmv(jnp.asarray(x)), C128)
    _close(P.mv_rows(to_torch(X)), J.mv_rows(jnp.asarray(X)), C128)


@pytest.mark.parametrize("dtype", [F64, F32, C128])
@pytest.mark.parametrize("dims", [(6, 5, 4), (9, 7)])
def test_gradient_operator_matches_jax(rng, dims, dtype):
    """mv and rmv on 1-D and 2-D x, mv_rows, the shape, and the adjoint
    identity <G x, y> = <x, G^H y>."""
    J, P = _gradient(dims, dtype)
    m, n = J.shape
    assert P.shape == (m, n) and P.dtype == to_torch(np.zeros(1, dtype)).dtype
    x, y = _panel(rng, 1, n, dtype)[0], _panel(rng, 1, m, dtype)[0]
    X2, Y2 = _panel(rng, 3, n, dtype).T, _panel(rng, 3, m, dtype).T
    # compiled: the JAX operator's ops run eagerly compile one by one
    mv, rmv, mv_rows = jax.jit(J.mv), jax.jit(J.rmv), jax.jit(J.mv_rows)
    _close(P.mv(to_torch(x)), mv(jnp.asarray(x)), dtype)
    _close(P.rmv(to_torch(y)), rmv(jnp.asarray(y)), dtype)
    _close(P.mv(to_torch(X2)), mv(jnp.asarray(X2)), dtype)
    _close(P.rmv(to_torch(Y2)), rmv(jnp.asarray(Y2)), dtype)
    Xr = _panel(rng, 4, n, dtype)
    got = P.mv_rows(to_torch(Xr))
    _close(got, mv_rows(jnp.asarray(Xr)), dtype)
    for i in range(4):
        assert torch.equal(got[i], P.mv(to_torch(Xr[i])))
    Gx, Ghy = P.mv(to_torch(x)), P.rmv(to_torch(y))
    lhs = complex(torch.sum(Gx.conj() * to_torch(y)))
    rhs = complex(torch.sum(to_torch(x).conj() * Ghy))
    tol = 1e-5 if dtype == F32 else 1e-12
    assert abs(lhs - rhs) <= tol * np.linalg.norm(x) * np.linalg.norm(y) * 4


def test_gradient_masks_are_computed_once_per_device():
    _, P = _gradient((5, 4, 3), F64)
    P.mv(torch.ones(60, dtype=torch.float64))
    masks = P._masks[torch.device(CPU)]
    P.rmv(torch.ones(180, dtype=torch.float64))
    assert P._masks[torch.device(CPU)] is masks and len(masks) == 3
    # the CSR form (held against the JAX package's in test_torch_sparse.py)
    # is built on the host, not from the masks
    assert P.to_csr().shape == P.shape
    assert P._masks[torch.device(CPU)] is masks


# ---- block CG --------------------------------------------------------------------

def _hpd(rng, n, dtype):
    A = rng.standard_normal((n, n))
    if np.issubdtype(dtype, np.complexfloating):
        A = A + 1j * rng.standard_normal((n, n))
    return (A @ A.conj().T / n + np.eye(n)).astype(dtype)


BLOCK_CG = {  # name: (operator maker, dtype, keywords)
    "laplace_dia(10,2)": (lambda r: jfix.laplace_dia(10, 2, dtype=F64), F64,
                          dict(reltol=1e-10)),
    "laplacian(6,3) stencil": (lambda r: jits.laplacian(6, 3, dtype=F64), F64,
                               dict(reltol=1e-10)),
    "dense complex128": (lambda r: _hpd(r, 60, C128), C128,
                         dict(reltol=1e-10)),
    "laplace_dia(10,2) f32": (lambda r: jfix.laplace_dia(10, 2, dtype=F32),
                              F32, dict(reltol=1e-5)),
    "laplacian(6,3) f32": (lambda r: jits.laplacian(6, 3, dtype=F32), F32,
                           dict(reltol=1e-5)),
}


def _port_op(A):
    if isinstance(A, jits.DIAMatrix):
        return port_dia(A)
    if isinstance(A, jits.StencilOperator):
        return port_stencil(A)
    return to_torch(A)


def _check_block(Xp, hp, Xj, hj, dtype):
    assert hp.isconverged == hj.isconverged
    np.testing.assert_array_equal(hp["converged_per_rhs"],
                                  np.asarray(hj["converged_per_rhs"]))
    if np.dtype(dtype) in (np.dtype(F64), np.dtype(C128)):
        assert (hp.iters, hp.mvps) == (hj.iters, hj.mvps)
        rj, rp = np.asarray(hj["resnorm"]), hp["resnorm"]
        assert rp.shape == rj.shape
        np.testing.assert_allclose(rp, rj, rtol=1e-10,
                                   atol=1e-13 * rj.max())
        assert rel(to_numpy(Xp), np.asarray(Xj)) <= 1e-10
    else:
        assert abs(hp.iters - hj.iters) <= 2
        assert rel(to_numpy(Xp), np.asarray(Xj)) <= 1e-4
    assert (hp["reltol"], hp["abstol"]) == (hj["reltol"], hj["abstol"])


@pytest.mark.parametrize("name", list(BLOCK_CG))
def test_block_cg_matches_jax(rng, name):
    """Four right-hand sides of different sizes (so the columns converge at
    different steps and freeze while the others go on)."""
    make, dtype, kw = BLOCK_CG[name]
    A = make(rng)
    n = A.shape[0]
    B = _panel(rng, 4, n, dtype).T * np.array([1.0, 1e-3, 10.0, 1.0])
    B[:, 3] = 1.0
    Xj, hj = jits.block_cg(A, B, log=True, **kw)
    Xp, hp = pits.block_cg(_port_op(A), to_torch(B), log=True, **kw)
    assert Xp.shape == (n, 4) and Xp.device == torch.device(CPU)
    _check_block(Xp, hp, Xj, hj, dtype)
    # a column solved alone by cg takes the steps of its column here
    if dtype == F64:
        _, h1 = pits.cg(_port_op(A), to_torch(B[:, 2]), log=True, **kw)
        last = np.nonzero(hp["resnorm"][:, 2] != hp["resnorm"][-1, 2])[0]
        assert h1.iters == (last[-1] + 2 if last.size else 1)


def test_block_cg_preconditioned_x0_and_chunks_match_jax(rng):
    """A Jacobi Pl and a nonzero x0 (JAX's tests/test_block_cg cases); the
    numerics are the same at every chunk."""
    A = jfix.laplace_dia(10, 2, dtype=F64)
    n = A.shape[0]
    B = _panel(rng, 3, n, F64).T
    x0 = _panel(rng, 3, n, F64).T
    d = np.asarray(A.to_dense()).diagonal().copy()
    kw = dict(reltol=1e-9, maxiter=60)
    Xj, hj = jits.block_cg(A, B, x0=x0, Pl=jits.DiagonalPreconditioner(d),
                           log=True, **kw)
    runs = [pits.block_cg(port_dia(A), to_torch(B), x0=to_torch(x0),
                          Pl=to_torch(d), log=True, chunk=c, **kw)
            for c in (1, 8, 256)]
    for Xp, hp in runs:
        _check_block(Xp, hp, Xj, hj, F64)
        assert torch.equal(Xp, runs[0][0])


def test_block_cg_maxiter_and_iterator(rng):
    """Stepping the iterator gives the one-shot solve's iterate (the
    unmasked step: the same numbers), and a maxiter cut stops both
    packages at the same place."""
    A = jfix.laplace_dia(10, 2, dtype=F64)
    B = _panel(rng, 2, A.shape[0], F64).T
    X1, h1 = pits.block_cg(port_dia(A), to_torch(B), reltol=1e-10, log=True)
    it = pits.block_cg_iterator(port_dia(A), to_torch(B), reltol=1e-10)
    trace = [r.clone() for r in it]
    assert len(trace) == h1.iters
    torch.testing.assert_close(it.x.T, X1, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(np.stack([to_numpy(r) for r in trace]),
                               h1["resnorm"], rtol=1e-14)
    Xj, hj = jits.block_cg(A, B, reltol=1e-10, maxiter=7, log=True)
    Xp, hp = pits.block_cg(port_dia(A), to_torch(B), reltol=1e-10,
                           maxiter=7, log=True)
    assert hp.iters == hj.iters == 7 and not hp.isconverged
    assert rel(to_numpy(Xp), np.asarray(Xj)) <= 1e-10
    with pytest.raises(ValueError, match="B of shape"):
        pits.block_cg(port_dia(A), to_torch(B[:, 0]))


# ---- LSQR and LSMR ---------------------------------------------------------------

def _mesh_operator():
    """A matrix operator that says it is row-sharded over two ranks."""
    op = plo.MatrixOperator(torch.eye(8, dtype=torch.float64))
    op.mesh = types.SimpleNamespace(size=2)
    return op


@pytest.mark.parametrize("call", [
    lambda op: pits.block_cg(op, torch.ones(8, 2, dtype=torch.float64)),
    lambda op: pits.lsqr(op, torch.ones(8, dtype=torch.float64)),
    lambda op: pits.lsmr(op, torch.ones(8, dtype=torch.float64)),
    lambda op: pits.lobpcg(op, torch.ones(8, 2, dtype=torch.float64)),
    lambda op: pits.svdl(op, nsv=2),
], ids=["block_cg", "lsqr", "lsmr", "lobpcg", "svdl"])
def test_solvers_on_a_mesh_operator_raise(call):
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        call(_mesh_operator())


def _lsq_problem(rng, name):
    """name -> (JAX operator, port operator, b, dtype)."""
    if name.startswith("dense"):
        dtype = F32 if name.endswith("f32") else F64
        m, n = 200, 120
        A = (rng.standard_normal((m, n)) + 3 * np.eye(m, n)).astype(dtype)
        b = rng.standard_normal(m).astype(dtype)
        return jnp.asarray(A), to_torch(A), b, dtype
    if name == "complex":
        m, n = 150, 90
        A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
             + 4 * np.eye(m, n))
        b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
        return jnp.asarray(A), to_torch(A), b, C128
    if name == "gradient":
        J, P = _gradient((8, 8, 8), F64)
        x_true = rng.standard_normal(J.n)
        x_true -= x_true.mean()
        return J, P, np.asarray(J.mv(jnp.asarray(x_true))), F64
    if name == "shifted stencil":
        St = jits.StencilOperator(512, 7.0, jits.laplacian(8, 3).terms,
                                  [-1.0] * 6, dtype=F64)
        return St, port_stencil(St), np.ones(512), F64
    if name == "shifted stencil f32":
        St = jits.StencilOperator(512, 7.0, jits.laplacian(8, 3).terms,
                                  [-1.0] * 6, dtype=F32)
        return St, port_stencil(St), np.ones(512, F32), F32
    raise KeyError(name)


LSQ = {  # name: (problem, keywords for both solvers, damping)
    "dense overdetermined": ("dense", dict(atol=1e-8, btol=1e-8), 0.0),
    "dense damped": ("dense", dict(atol=1e-8, btol=1e-8), 1.0),
    "dense f32": ("dense f32", dict(), 0.0),
    "complex": ("complex", dict(atol=1e-8, btol=1e-8), 0.0),
    "gradient damped": ("gradient", dict(atol=1e-8, btol=1e-8), 1.0),
    "gradient maxiter (istop 7)": ("gradient", dict(maxiter=5), 0.0),
    "shifted stencil (kernel rmv)": ("shifted stencil",
                                     dict(atol=1e-9, btol=1e-9), 0.0),
    "shifted stencil f32": ("shifted stencil f32", dict(atol=1e-5,
                                                        btol=1e-5), 0.0),
}


def _rel_max(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300),
                        initial=0.0))


def _jax_lsq(solver, J, b, **kw):
    """The JAX package's solve of b and of b (1 + 1e-15): the second
    measures how far rounding alone moves its answer."""
    xj, hj = getattr(jits, solver)(J, jnp.asarray(b), log=True, **kw)
    xm, hm = getattr(jits, solver)(J, jnp.asarray(b) * (1 + 1e-15), log=True,
                                   **kw)
    return xj, hj, (np.asarray(xm), hm)


def _check_lsq(xp, hp, xj, hj, dtype, moved):
    """The module's tolerances: f64 within 1e-10 plus four times the JAX
    package's own spread (``moved``: its x and history for b (1 + 1e-15))."""
    assert hp.isconverged == hj.isconverged
    assert hp["istop"] == hj["istop"]
    for key in ("atol", "btol", "ctol"):
        assert hp[key] == hj[key]
    if np.dtype(dtype) in (np.dtype(F64), np.dtype(C128)):
        xm, hm = moved
        assert (hp.iters, hp.mvps, hp.mtvps) == (hj.iters, hj.mvps, hj.mtvps)
        for key in hj.data:
            if key in ("atol", "btol", "ctol", "istop"):
                continue
            want = np.asarray(hj[key])
            assert hp[key].shape == want.shape, key
            limit = 1e-10 + 4 * _rel_max(hm[key], want)
            assert _rel_max(hp[key], want) <= limit, (key, limit)
        xj = np.asarray(xj)
        assert rel(to_numpy(xp), xj) <= 1e-10 + 4 * rel(xm, xj)
    else:
        assert abs(hp.iters - hj.iters) <= 2
        assert rel(to_numpy(xp), np.asarray(xj)) <= 1e-4


@pytest.mark.parametrize("solver", ["lsqr", "lsmr"])
@pytest.mark.parametrize("name", list(LSQ))
def test_least_squares_matches_jax(rng, name, solver):
    """tests/test_leastsquares.py's cases (overdetermined, damped, maxiter
    with istop 7, complex) and the port's operators: the gradient (``rmv``
    its adjoint) and the stencil (``rmv`` the kernel's route with
    ``conj=True``)."""
    problem, kw, damp = LSQ[name]
    J, P, b, dtype = _lsq_problem(rng, problem)
    kw = dict(kw)
    kw["damp" if solver == "lsqr" else "lam"] = damp
    xj, hj, moved = _jax_lsq(solver, J, b, **kw)
    xp, hp = getattr(pits, solver)(P, to_torch(b), log=True, **kw)
    assert xp.device == torch.device(CPU)
    if "istop 7" in name:
        assert hp["istop"] == 7 and hp.iters == 5
    _check_lsq(xp, hp, xj, hj, dtype, moved)


@pytest.mark.parametrize("solver", ["lsqr", "lsmr"])
def test_least_squares_zero_rhs_and_x0(rng, solver):
    """b = 0 returns x0 = 0 without a step (the Arnorm == 0 early exit);
    a nonzero x0 agrees with the JAX package."""
    J, P, b, _ = _lsq_problem(rng, "dense")
    xj, hj = getattr(jits, solver)(J, jnp.zeros(200), log=True)
    xp, hp = getattr(pits, solver)(P, torch.zeros(200, dtype=torch.float64),
                                   log=True)
    assert hp.iters == hj.iters == 0 and not to_numpy(xp).any()
    assert (hp.isconverged, hp["istop"]) == (hj.isconverged, hj["istop"])
    x0 = rng.standard_normal(120)
    kw = dict(atol=1e-8, btol=1e-8, x0=x0)
    xj, hj, moved = _jax_lsq(solver, J, b, **kw)
    kw["x0"] = to_torch(x0)
    xp, hp = getattr(pits, solver)(P, to_torch(b), log=True, **kw)
    _check_lsq(xp, hp, xj, hj, F64, moved)


@pytest.mark.parametrize("solver", ["lsqr", "lsmr"])
def test_least_squares_verbose_prints_each_step(rng, solver, capsys):
    """``verbose`` prints one line a step, the JAX package's columns."""
    J, P, b, _ = _lsq_problem(rng, "dense")
    x, h = getattr(pits, solver)(P, to_torch(b), atol=1e-8, btol=1e-8,
                                 log=True, verbose=True)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == h.iters
    assert lines[0].split("\t")[0].strip() == "1"
    assert len(lines[0].split("\t")) == (5 if solver == "lsqr" else 4)
