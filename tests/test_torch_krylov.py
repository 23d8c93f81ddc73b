"""The port's MINRES, QMR, Chebyshev and pipelined CG, its spectral bounds
and its dense preconditioner against the JAX package's, on the CPU, on the
same inputs (numpy, seeded).

Tolerances: f64 (and complex128) equal step and product counts, the
residual series within 1e-8 relative wherever the JAX series lies above
1e-12 |r0|, x within 1e-10 relative; f32 (and complex64) steps within 2 and
x within 1e-4 relative (sums are taken in other orders).  Pipelined CG's
lagged norm comes from three more recurrences, each of which carries a
rounding of ~eps |r0| from step to step: its series is held within 1e-8
relative above 1e-6 |r0| and within 1e-14 |r0| down to 1e-12 |r0|.
"""

import numpy as np
import pytest
import torch

import iterativesolvers_tpu as jits
from iterativesolvers_tpu.utils import fixtures as jfix

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.solvers import common as pcommon

from _torch_port import CPU, port_dia, port_stencil, rel, to_numpy, to_torch

torch.set_num_threads(1)

F64, F32 = np.float64, np.float32


def _port(A):
    if isinstance(A, jits.DIAMatrix):
        return port_dia(A)
    if isinstance(A, jits.StencilOperator):
        return port_stencil(A)
    return to_torch(A)


def _r0(A, b, x0):
    if x0 is None:
        return float(np.linalg.norm(b))
    Ax = (np.asarray(A) @ x0 if isinstance(A, np.ndarray)
          else np.asarray(A.mv(x0)))
    return float(np.linalg.norm(b - Ax))


def check_against_jax(xp, hp, xj, hj, dtype, r0, floor=1e-12):
    """The tolerances of the module docstring (the residual series compared
    in relative terms above ``floor`` |r0|, and in absolute terms, within
    1e-14 |r0|, from there down to 1e-12 |r0|); also the tolerances the
    histories record."""
    assert xp.device == torch.device(CPU)
    assert hp.isconverged == hj.isconverged
    if np.dtype(dtype) in (np.dtype(F64), np.dtype(np.complex128)):
        assert (hp.iters, hp.mvps, hp.mtvps) == (hj.iters, hj.mvps, hj.mtvps)
        rj, rp = np.asarray(hj["resnorm"]), np.asarray(hp["resnorm"])
        assert rp.shape == rj.shape
        big, mid = rj > floor * r0, rj > 1e-12 * r0
        np.testing.assert_allclose(rp[big], rj[big], rtol=1e-8)
        np.testing.assert_allclose(rp[mid], rj[mid], rtol=0, atol=1e-14 * r0)
        assert rel(to_numpy(xp), np.asarray(xj)) <= 1e-10
    else:
        assert abs(hp.iters - hj.iters) <= 2
        assert rel(to_numpy(xp), np.asarray(xj)) <= 1e-4
    if "reltol" in hj.data:
        assert hp["reltol"] == hj["reltol"] and hp["abstol"] == hj["abstol"]


def _rhs(n, dtype, seed=3):
    r = np.random.default_rng(seed)
    b = r.standard_normal(n)
    if np.issubdtype(dtype, np.complexfloating):
        b = b + 1j * r.standard_normal(n)
    return b.astype(dtype)


def _dense(kind, dtype, n=15, seed=5):
    """tests/test_minres.py's Hermitian problem B + B^H, and i times it, a
    skew-Hermitian matrix with the same condition.  (Its own skew problem
    B - B^H converges only at step n, where a change of b by 1e-15 moves the
    residual estimates of the last steps by 5x in either package.)"""
    rng = np.random.default_rng(seed)
    B = rng.random((n, n))
    if np.issubdtype(dtype, np.complexfloating):
        B = B + 1j * rng.random((n, n))
    B = B.astype(dtype) + n * np.eye(n, dtype=dtype)
    H = B + B.conj().T
    return H if kind == "hermitian" else (1j * H).astype(dtype)


# ---- MINRES -----------------------------------------------------------------

MINRES_OPS = {
    "laplace_dia(6,3)": lambda dt: jfix.laplace_dia(6, 3, dtype=dt),
    "laplacian(6,3)": lambda dt: jits.laplacian(6, 3, dtype=dt),
    # indefinite: eigenvalues 0.5 + 2 cos(k pi / 61) on both sides of 0
    "sym_tridiagonal_dia(0.5,1,60)": lambda dt: jfix.sym_tridiagonal_dia(
        0.5, 1.0, 60, dtype=dt),
}


@pytest.mark.parametrize("x0", [False, True])
@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("op", list(MINRES_OPS))
def test_minres_matches_jax(op, dtype, x0):
    A = MINRES_OPS[op](dtype)
    n = A.shape[0]
    b = _rhs(n, dtype)
    x0v = (0.1 * _rhs(n, dtype, seed=9)).astype(dtype) if x0 else None
    kw = dict(reltol=1e-9 if dtype == F64 else 1e-5, maxiter=4 * n, log=True)
    xj, hj = jits.minres(A, b, x0=x0v, **kw)
    xp, hp = pits.minres(_port(A), b, x0=x0v, **kw)
    assert hp.isconverged
    check_against_jax(xp, hp, xj, hj, dtype, _r0(A, b, x0v))


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("kind", ["hermitian", "skew"])
def test_minres_complex_dense_matches_jax(kind, dtype):
    """A complex Hermitian and a skew-Hermitian system (``skew_hermitian``:
    the complex Hessenberg column), as dense matrices."""
    A = _dense(kind, dtype)
    b = _rhs(A.shape[0], dtype)
    kw = dict(skew_hermitian=kind == "skew", maxiter=150, log=True,
              reltol=1e-9 if dtype == np.complex128 else 1e-5)
    xj, hj = jits.minres(A, b, **kw)
    xp, hp = pits.minres(to_torch(A), b, **kw)
    assert hp.isconverged
    check_against_jax(xp, hp, xj, hj, dtype, _r0(A, b, None))


# ---- QMR --------------------------------------------------------------------

QMR_OPS = {
    "advection_diffusion(6)": lambda dt: jfix.advection_diffusion(
        6, dtype=dt)[0],
    "advection_diffusion_stencil(6)": lambda dt:
        jits.advection_diffusion_stencil(6, dtype=dt),
    "laplace_dia(6,3)": lambda dt: jfix.laplace_dia(6, 3, dtype=dt),
}


@pytest.mark.parametrize("x0", [False, True])
@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("op", list(QMR_OPS))
def test_qmr_matches_jax(op, dtype, x0):
    """QMR's rmv: the DIA matrix's adjoint and the stencil's (conj=True)."""
    A = QMR_OPS[op](dtype)
    n = A.shape[0]
    b = _rhs(n, dtype)
    x0v = (0.1 * _rhs(n, dtype, seed=9)).astype(dtype) if x0 else None
    kw = dict(reltol=1e-9 if dtype == F64 else 1e-5, maxiter=4 * n, log=True)
    xj, hj = jits.qmr(A, b, x0=x0v, **kw)
    xp, hp = pits.qmr(_port(A), b, x0=x0v, **kw)
    assert hp.isconverged and hp.mtvps == hp.iters
    check_against_jax(xp, hp, xj, hj, dtype, _r0(A, b, x0v))


def test_qmr_complex_dense_and_breakdown_match_jax():
    """A complex non-Hermitian dense system; and the Lanczos breakdown of
    the identity (delta = 0 after one step), which both packages end as
    converged with the first iterate."""
    rng = np.random.default_rng(2)
    n = 20
    A = (rng.random((n, n)) + 1j * rng.random((n, n)) + n * np.eye(n))
    b = _rhs(n, np.complex128)
    xj, hj = jits.qmr(A, b, reltol=1e-10, log=True)
    xp, hp = pits.qmr(to_torch(A), b, reltol=1e-10, log=True)
    check_against_jax(xp, hp, xj, hj, np.complex128, _r0(A, b, None))
    eye = np.eye(8)
    xj, hj = jits.qmr(eye, np.ones(8), log=True)
    xp, hp = pits.qmr(to_torch(eye), np.ones(8), log=True)
    assert (hp.iters, hp.isconverged) == (hj.iters, hj.isconverged)
    assert rel(to_numpy(xp), np.asarray(xj)) <= 1e-12


# ---- Chebyshev --------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "jacobi", "warm_x0"])
@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("op", ["laplace_dia(6,3)", "laplacian(6,3)"])
def test_chebyshev_matches_jax(op, dtype, case):
    """Bounds around laplace(6, 3)'s spectrum, 6 -+ 6 cos(pi / 7)."""
    A = MINRES_OPS[op](dtype)
    n = A.shape[0]
    b = _rhs(n, dtype)
    kw = dict(reltol=1e-9 if dtype == F64 else 1e-5, maxiter=600, log=True)
    x0v = ((0.1 * _rhs(n, dtype, seed=9)).astype(dtype)
           if case == "warm_x0" else None)
    if case == "jacobi":
        kw["Pl"] = np.full(n, 6.0, dtype)
        lmin, lmax = 0.08, 1.92
    else:
        lmin, lmax = 0.5, 11.5
    xj, hj = jits.chebyshev(A, b, lmin, lmax, x0=x0v, **kw)
    xp, hp = pits.chebyshev(_port(A), b, lmin, lmax, x0=x0v, **kw)
    assert hp.isconverged
    check_against_jax(xp, hp, xj, hj, dtype, _r0(A, b, x0v))


# ---- pipelined CG -----------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "jacobi", "warm_x0"])
@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("op", ["laplace_dia(6,3)", "laplacian(6,3)"])
def test_pipelined_cg_matches_jax(op, dtype, case):
    """The lagged residual series (one entry fewer than the steps) and the
    products: one a step and one (two with x0) before the first."""
    A = MINRES_OPS[op](dtype)
    n = A.shape[0]
    b = _rhs(n, dtype)
    kw = dict(reltol=1e-9 if dtype == F64 else 1e-5, log=True)
    x0v = ((0.1 * _rhs(n, dtype, seed=9)).astype(dtype)
           if case == "warm_x0" else None)
    if case == "jacobi":
        kw["Pl"] = (6.0 * (1 + 0.5 * np.random.default_rng(4).random(n))
                    ).astype(dtype)
    xj, hj = jits.pipelined_cg(A, b, x0=x0v, **kw)
    xp, hp = pits.pipelined_cg(_port(A), b, x0=x0v, **kw)
    assert hp.isconverged
    assert hp.mvps == hp.iters + 1 + (x0v is not None)
    assert len(hp["resnorm"]) == hp.iters - 1
    check_against_jax(xp, hp, xj, hj, dtype, _r0(A, b, x0v), floor=1e-6)


# ---- spectral bounds and the dense preconditioner ---------------------------

BOUND_OPS = {
    "laplacian(6,3)": lambda: jits.laplacian(6, 3, dtype=F64),
    "advection_diffusion_stencil(6)": lambda:
        jits.advection_diffusion_stencil(6, dtype=F64),
    "laplace_dia(6,3)": lambda: jfix.laplace_dia(6, 3, dtype=F64),
    "advection_diffusion(6)": lambda: jfix.advection_diffusion(
        6, dtype=F64)[0],
    "sym_tridiagonal_dia": lambda: jfix.sym_tridiagonal_dia(
        4.0, -1.5, 30, dtype=F64),
}


@pytest.mark.parametrize("op", list(BOUND_OPS))
def test_gershgorin_bounds_match_jax(op):
    """The stencil's bounds from its terms, the DIA matrix's from its
    diagonals, against the JAX package's (stencil terms; CSR): equal to
    1e-12."""
    A = BOUND_OPS[op]()
    np.testing.assert_allclose(pits.gershgorin_bounds(_port(A)),
                               jits.gershgorin_bounds(A), rtol=1e-12,
                               atol=1e-12)


def test_gershgorin_bounds_other_operators_raise():
    """An operator with neither terms, diagonals nor a CSR form raises (the
    JAX package fails on its missing ``to_csr``)."""
    with pytest.raises(TypeError, match="CSR form"):
        pits.gershgorin_bounds(pits.MatrixOperator(torch.eye(3)))


@pytest.mark.parametrize("dtype", [F64, F32])
def test_power_bound_matches_jax(dtype):
    """A diagonal DIA matrix with a dominant eigenvalue 20 (the next 10):
    30 power steps from any start reach it to 2^-30, so the port's estimate
    (torch start vector) and the JAX package's (jax.random start) agree
    with 20 * safety to 1e-8 (f64) or 1e-5 (f32)."""
    d = np.concatenate([np.linspace(1.0, 10.0, 40), [20.0]]).astype(dtype)
    A = jits.DIAMatrix(d[None, :], (0,), (41, 41))
    P = port_dia(A)
    tol = 1e-8 if dtype == F64 else 1e-5
    gen = torch.Generator().manual_seed(3)
    for got in (float(pits.power_bound(P, key=gen)),
                float(pits.power_bound(P)),
                float(jits.power_bound(A))):
        assert abs(got - 21.0) <= tol * 21.0
    got = float(pits.power_bound(P, iters=40, safety=1.0))
    assert abs(got - float(jits.power_bound(A, iters=40, safety=1.0))) <= (
        tol * 20.0)


def test_dense_preconditioner_matches_jax():
    """``as_preconditioner`` of a 2-D array is a DensePreconditioner (an LU
    factorization on the array's device); its ldiv against the JAX
    package's, and CG preconditioned by it (f64: equal steps, x 1e-10)."""
    A = jfix.laplace_dia(6, 3, dtype=F64)
    n = A.shape[0]
    rng = np.random.default_rng(8)
    M = np.diag(6.0 + rng.random(n)) + 0.05 * rng.random((n, n))
    P = pits.operators.preconditioners.as_preconditioner(M, device=CPU)
    assert isinstance(P, pits.DensePreconditioner)
    assert P.lu_and_piv[0].device == torch.device(CPU)
    J = jits.DensePreconditioner(M)
    v = rng.standard_normal(n)
    np.testing.assert_allclose(to_numpy(P.ldiv(to_torch(v))),
                               np.asarray(J.ldiv(v)), rtol=1e-12, atol=1e-14)
    V = rng.standard_normal((n, 3))
    np.testing.assert_allclose(to_numpy(P.ldiv(to_torch(V))),
                               np.asarray(J.ldiv(V)), rtol=1e-12, atol=1e-14)
    b = _rhs(n, F64)
    xj, hj = jits.cg(A, b, Pl=M, reltol=1e-10, log=True)
    xp, hp = pits.cg(port_dia(A), b, Pl=to_torch(M), reltol=1e-10, log=True)
    check_against_jax(xp, hp, xj, hj, F64, _r0(A, b, None))


# ---- iterators, printouts, random draws -------------------------------------


def test_iterators_match_the_solves():
    """Each eager iterator, stepped to its end, gives its solve's x and
    steps (f64), and a step leaves the state it was given as it was."""
    A = jfix.laplace_dia(6, 3, dtype=F64)
    P = port_dia(A)
    b = _rhs(A.shape[0], F64)
    cases = [
        (pits.minres_iterator(P, b, reltol=1e-9),
         pits.minres(P, b, reltol=1e-9, log=True)),
        (pits.qmr_iterator(P, b, reltol=1e-9),
         pits.qmr(P, b, reltol=1e-9, log=True)),
        (pits.chebyshev_iterator(P, b, 0.5, 11.5, reltol=1e-9),
         pits.chebyshev(P, b, 0.5, 11.5, reltol=1e-9, log=True)),
    ]
    for it, (x, h) in cases:
        first = it.state
        saved = [t.clone() for t in first]
        steps = sum(1 for _ in it)
        assert all(torch.equal(a, c) for a, c in zip(first, saved))
        assert steps == h.iters
        assert rel(to_numpy(it.x), to_numpy(x)) <= 1e-12
    xj = np.asarray(jits.minres(A, b, reltol=1e-9))
    assert rel(to_numpy(cases[0][0].x), xj) <= 1e-10


def test_verbose_prints_every_step_once(capsys):
    """``verbose=True`` prints one line a step, numbered from 1, at the
    end of each run_chunked phase (live_print): the residual log, whatever
    the phase lengths."""
    P = pits.laplacian(6, 3, dtype=torch.float64, device=CPU)
    b = _rhs(P.n, F64)
    for chunk in (1, 256):
        x, h = pits.minres(P, b, reltol=1e-9, verbose=True, log=True,
                           chunk=chunk)
        lines = capsys.readouterr().out.splitlines()
        assert len(lines) == h.iters
        assert lines[0].split() == ["1", f"{h['resnorm'][0]:.2e}"]
        assert lines[-1].split()[0] == str(h.iters)


def test_random_like_draws_from_the_generator():
    """Uniform [0, 1) draws from the generator on its device; complex dtypes
    get independent real and imaginary parts; the same seed the same
    draw; with a mesh, this rank's rows of the one-device draw."""
    def gen():
        return torch.Generator().manual_seed(4)

    r = pcommon.random_like(gen(), (3, 100), torch.float64)
    assert r.shape == (3, 100) and r.dtype == torch.float64
    assert 0 <= float(r.min()) and float(r.max()) < 1
    assert torch.equal(r, pcommon.random_like(gen(), (3, 100), "float64"))
    c = pcommon.random_like(gen(), (100,), torch.complex128)
    assert c.dtype == torch.complex128
    assert not torch.equal(c.real, c.imag)

    class Mesh:
        size, rank = 4, 3

    blk = pcommon.random_like(gen(), (3, 101), torch.float64, mesh=Mesh)
    full = pcommon.random_like(gen(), (3, 101), torch.float64)
    assert torch.equal(blk, full[:, 78:])
