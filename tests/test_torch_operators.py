"""The port's operators (``iterativesolvers_tpu_torch/operators``, its
fixtures and ``utils/convert.py``) against the JAX package on the same
inputs.

Tolerances: rtol 1e-12 in f64; in f32 rtol 1e-6 with atol 1e-6 * max|y|,
since the port's stencil sums its terms in another order than the JAX
``_apply`` (see ``csrc/stencil.cu``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterativesolvers_tpu as jits
from iterativesolvers_tpu.operators import sparse as jsparse
from iterativesolvers_tpu.utils import fixtures as jfix

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.operators import preconditioners as pprec
from iterativesolvers_tpu_torch.operators import sparse as psparse
from iterativesolvers_tpu_torch.utils import convert
from iterativesolvers_tpu_torch.utils import fixtures as pfix

from _torch_port import CPU, port_dia, port_stencil, to_numpy, to_torch

torch.set_num_threads(1)

TOL = {np.float64: dict(rtol=1e-12), np.float32: dict(rtol=1e-6)}


def _close(got, want, dtype):
    want = np.asarray(want)
    atol = 0.0 if dtype == np.float64 else 1e-6 * float(np.max(np.abs(want)))
    np.testing.assert_allclose(to_numpy(got), want, atol=atol, **TOL[dtype])


def _close_dot(got, want, dtype):
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert abs(float(got) - float(want)) <= tol * abs(float(want))


STENCILS = {
    "laplacian(24,3)": lambda dt: jits.laplacian(24, 3, dtype=dt),
    "advection_diffusion_stencil(12)":
        lambda dt: jits.advection_diffusion_stencil(12, dtype=dt),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", list(STENCILS))
def test_stencil_mv_rmv_mv_dot_match_jax(rng, name, dtype):
    St = STENCILS[name](dtype)
    Pt = port_stencil(St)
    assert Pt.dtype == to_torch(np.zeros(1, dtype)).dtype
    x = rng.standard_normal(St.n).astype(dtype)
    xj, xt = jnp.asarray(x), to_torch(x)
    _close(Pt.mv(xt), St._apply(xj, conj=False), dtype)
    _close(Pt.rmv(xt), St._apply(xj, conj=True), dtype)
    y, d = Pt.mv_dot(xt)
    yj, dj = St.mv_dot(xj)
    _close(y, yj, dtype)
    _close_dot(d, dj, dtype)
    _close(Pt @ xt, yj, dtype)
    _close(Pt.H.mv(xt), St._apply(xj, conj=True), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dia_mv_rmv_mv_dot_match_jax(rng, dtype):
    A = jfix.laplace_dia(16, 3, dtype=dtype)
    P = port_dia(A)
    x = rng.standard_normal(A.shape[0]).astype(dtype)
    xj, xt = jnp.asarray(x), to_torch(x)
    _close(P.mv(xt), A.mv(xj), dtype)
    _close(P.rmv(xt), A.rmv(xj), dtype)
    y, d = P.mv_dot(xt)
    yj, dj = A.mv_dot(xj)
    _close(y, yj, dtype)
    _close_dot(d, dj, dtype)


def test_dia_nonsymmetric_rmv_and_block_vectors_match_jax(rng):
    A, _ = jfix.advection_diffusion(6)
    P = port_dia(A)
    X = rng.standard_normal((A.shape[0], 3))
    _close(P.mv(to_torch(X)), A.mv(jnp.asarray(X)), np.float64)
    _close(P.rmv(to_torch(X)), A.rmv(jnp.asarray(X)), np.float64)
    np.testing.assert_array_equal(to_numpy(P.to_dense()),
                                  np.asarray(A.to_dense()))
    d, present = P.diagonal()
    dj, presentj = A.diagonal()
    np.testing.assert_array_equal(to_numpy(d), dj)
    np.testing.assert_array_equal(to_numpy(present), presentj)


def test_rectangular_dia_matches_jax(rng):
    diags = [rng.standard_normal(5), rng.standard_normal(5)]
    A = jits.DIAMatrix(diags, (0, 2), (5, 7))
    P = pits.DIAMatrix([to_torch(d) for d in diags], (0, 2), (5, 7),
                       device=CPU)
    x, u = rng.standard_normal(7), rng.standard_normal(5)
    _close(P.mv(to_torch(x)), A.mv(jnp.asarray(x)), np.float64)
    _close(P.rmv(to_torch(u)), A.rmv(jnp.asarray(u)), np.float64)
    np.testing.assert_array_equal(to_numpy(P.to_dense()),
                                  np.asarray(A.to_dense()))


@pytest.mark.parametrize("side,dims", [(7, 2), (6, 3)])
def test_laplacian_to_dia_equals_laplace_dia(side, dims):
    got = pits.laplacian(side, dims, dtype=torch.float64, device=CPU).to_dia()
    want = pfix.laplace_dia(side, dims, device=CPU)
    jwant = jfix.laplace_dia(side, dims)
    assert got.offsets == want.offsets == jwant.offsets
    for g, w, j in zip(got.diags, want.diags, jwant.diags):
        assert torch.equal(g, w)
        np.testing.assert_array_equal(to_numpy(g), np.asarray(j))


def _scaled_laplace(scale):
    A = jfix.laplace_dia(5, 2)
    return jits.DIAMatrix([np.asarray(d) * scale for d in A.diags], A.offsets,
                          A.shape)


@pytest.mark.parametrize("case", ["integers", "halves", "thirds"])
@pytest.mark.parametrize("dtype", [None, "bfloat16", "int8"])
def test_compress_values_picks_the_jax_dtype(case, dtype):
    A = {"integers": jfix.laplace_dia(5, 2, dtype=np.float32),
         "halves": _scaled_laplace(0.5),
         "thirds": _scaled_laplace(1.0 / 3.0)}[case]
    P = port_dia(A)
    jdt = None if dtype is None else getattr(jnp, dtype)
    pdt = None if dtype is None else getattr(torch, dtype)
    want = jsparse.compress_values(A, jdt)
    got = psparse.compress_values(P, pdt)
    assert str(got.dtype).removeprefix("torch.") == np.dtype(want.dtype).name
    if dtype is not None:
        assert (psparse.values_representable(P, pdt)
                == jsparse.values_representable(A, jdt))
        forced = psparse.compress_values(P, pdt, require_exact=False)
        assert forced.dtype == pdt
    np.testing.assert_array_equal(
        to_numpy(got.data.double()), np.asarray(want.data).astype(np.float64))


def test_compress_values_rejects_other_formats_like_jax():
    mat = np.eye(3)
    with pytest.raises(TypeError) as jerr:
        jsparse.compress_values(jits.MatrixOperator(jnp.asarray(mat)))
    with pytest.raises(TypeError) as perr:
        psparse.compress_values(pits.MatrixOperator(torch.eye(3)))
    assert str(perr.value) == str(jerr.value)


def test_fixtures_match_jax():
    for dtype in (np.float64, np.float32):
        A, P = (jfix.sym_tridiagonal_dia(2.0, -1.0, 9, dtype=dtype),
                pfix.sym_tridiagonal_dia(2.0, -1.0, 9, dtype=dtype, device=CPU))
        assert A.offsets == P.offsets
        np.testing.assert_array_equal(to_numpy(P.data), np.asarray(A.data))
    (A, b), (P, bp) = jfix.advection_diffusion(5), pfix.advection_diffusion(
        5, device=CPU)
    assert A.offsets == P.offsets
    np.testing.assert_array_equal(to_numpy(P.data), np.asarray(A.data))
    np.testing.assert_array_equal(bp, b)


def test_astype_and_dtype_promotion():
    P = pfix.laplace_dia(4, 2, dtype=np.float32, device=CPU)
    for dt in (torch.bfloat16, torch.int8, "bfloat16", np.int8):
        Q = P.astype(dt)
        assert Q.dtype in (torch.bfloat16, torch.int8)
        y = Q.mv(torch.ones(16))
        assert y.dtype == torch.float32
        assert torch.equal(y, P.mv(torch.ones(16)))


def test_convert_operator_from_arrays():
    A = jfix.laplace_dia(6, 2, dtype=np.float32)
    St = jits.advection_diffusion_stencil(5)
    P = convert.operator_from_arrays(
        {"kind": "dia", "diags": [np.asarray(d) for d in A.diags],
         "offsets": A.offsets, "shape": A.shape}, device=CPU)
    S = convert.operator_from_arrays(
        {"kind": "stencil", "n": St.n, "center": np.asarray(St.center),
         "terms": St.terms, "coeffs": [np.asarray(c) for c in St.coeffs],
         "dtype": np.float32}, device=CPU)
    assert isinstance(P, pits.DIAMatrix) and P.dtype == torch.float32
    assert isinstance(S, pits.StencilOperator) and S.terms == St.terms
    assert S.device == P.device == torch.device(CPU)
    with pytest.raises(ValueError, match="unknown operator kind"):
        convert.operator_from_arrays({"kind": "rb_reduced"}, device=CPU)


def test_dense_function_and_adjoint_operators_match_jax(rng):
    M = rng.standard_normal((6, 4))
    x, y = rng.standard_normal(4), rng.standard_normal(6)
    J = jits.as_operator(jnp.asarray(M))
    P = pits.as_operator(to_torch(M))
    assert isinstance(P, pits.MatrixOperator) and P.shape == (6, 4)
    _close(P.mv(to_torch(x)), J.mv(jnp.asarray(x)), np.float64)
    _close(P.rmv(to_torch(y)), J.rmv(jnp.asarray(y)), np.float64)
    _close(P.H.mv(to_torch(y)), J.H.mv(jnp.asarray(y)), np.float64)
    assert P.H.shape == (4, 6) and P.H.H is P
    Mt = to_torch(M)
    F = pits.FunctionOperator(lambda v: Mt @ v, (6, 4), torch.float64,
                              rmatvec=lambda v: Mt.T @ v, device=CPU)
    assert torch.equal(F.mv(to_torch(x)), P.mv(to_torch(x)))
    assert torch.equal(F.rmv(to_torch(y)), P.rmv(to_torch(y)))
    with pytest.raises(NotImplementedError, match="adjoint"):
        pits.FunctionOperator(lambda v: v, (3, 3), "float64",
                              device=CPU).rmv(torch.ones(3))
    b = torch.ones(5)
    G = pits.as_operator(lambda v: 2 * v, b)
    assert G.shape == (5, 5) and G.device == b.device
    yd, dd = G.mv_dot(b)
    assert torch.equal(yd, 2 * b) and float(dd) == 10.0
    with pytest.raises(ValueError, match="2-D"):
        pits.as_operator(torch.ones(3))


def test_preconditioners_match_jax(rng):
    d = 1.0 + rng.random(8)
    r = rng.standard_normal(8)
    assert pprec.is_identity(None)
    assert pprec.is_identity(pprec.as_preconditioner(None))
    D = pprec.as_preconditioner(to_torch(d), device=CPU)
    assert isinstance(D, pits.DiagonalPreconditioner)
    _close(D.ldiv(to_torch(r)),
           jits.as_preconditioner(jnp.asarray(d)).ldiv(jnp.asarray(r)),
           np.float64)
    F = pprec.as_preconditioner(lambda v: 3 * v)
    assert isinstance(F, pits.FunctionPreconditioner)
    assert torch.equal(F(to_torch(r)), 3 * to_torch(r))
    assert pprec.as_preconditioner(D) is D
    M = np.diag(d) + 0.1 * rng.random((8, 8))
    P = pprec.as_preconditioner(to_torch(M), device=CPU)
    assert isinstance(P, pits.DensePreconditioner)
    _close(P.ldiv(to_torch(r)),
           jits.as_preconditioner(jnp.asarray(M)).ldiv(jnp.asarray(r)),
           np.float64)


def test_operators_default_to_the_card():
    """Operators and fixtures take ``device="cuda"`` unless asked."""
    F = pits.FunctionOperator(abs, (2, 2), "float32")
    assert F.device == torch.device("cuda")
    for make in (pits.laplacian, pfix.laplace_dia):
        assert make(3, 2, device=CPU).device == torch.device(CPU)
        if not torch.cuda.is_available():
            with pytest.raises((AssertionError, RuntimeError)):
                make(3, 2)
