"""The port's BiCGStab(l), IDR(s) and power method against the JAX
package's, on the CPU, on the same inputs.

The random draws differ by design (``jax.random`` there, a
``torch.Generator`` here), so the two packages are compared through their
cores with the same numpy shadow residual (``_bicgstabl_core``) or shadow
space (``_idrs_core``), and ``powm`` from the same start vector.

Tolerances: f64 equal step and product counts, x within 1e-10 relative,
the residual series within 1e-8 relative wherever the JAX series lies above
1e-6 |r0| (1e-12 |r0| for the power method); f32 steps within 2 and x
within 1e-4 relative.  BiCGStab and IDR carry the rounding of each step
into the next, amplified: the JAX package against itself, with b changed by
one part in 1e15, moves their series by more than 1e-8 relative below
~1e-7 |r0| on the mildly nonsymmetric problems here (beta = 10), and by up
to 100% on the fixture's beta = 1000, whose steps then differ by one or
more.  So the problems are advection-diffusion at beta = 10, and the
series is compared above 1e-6 |r0|.
"""

import numpy as np
import pytest
import torch

import iterativesolvers_tpu as jits
from iterativesolvers_tpu.operators.preconditioners import \
    as_preconditioner as jprec
from iterativesolvers_tpu.solvers import bicgstabl as jbi
from iterativesolvers_tpu.solvers import idrs as jidrs
from iterativesolvers_tpu.solvers.common import resolve_tols as jtols
from iterativesolvers_tpu.utils import fixtures as jfix

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.operators.preconditioners import \
    as_preconditioner as pprec
from iterativesolvers_tpu_torch.solvers import bicgstabl as pbi
from iterativesolvers_tpu_torch.solvers import idrs as pidrs
from iterativesolvers_tpu_torch.solvers.common import random_like
from iterativesolvers_tpu_torch.solvers.common import resolve_tols as ptols

from _torch_port import CPU, port_dia, port_stencil, rel, to_numpy, to_torch

torch.set_num_threads(1)

F64, F32 = np.float64, np.float32

OPS = {
    "advection_diffusion(6)": lambda dt: jfix.advection_diffusion(
        6, beta=10.0, dtype=dt)[0],
    "advection_diffusion_stencil(6)": lambda dt:
        jits.advection_diffusion_stencil(6, beta=10.0, dtype=dt),
    "laplace_dia(6,3)": lambda dt: jfix.laplace_dia(6, 3, dtype=dt),
}


def _port(A):
    return port_dia(A) if isinstance(A, jits.DIAMatrix) else port_stencil(A)


def _vec(n, dtype, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _compare(xp, itp, logp, xj, itj, logj, dtype, r0, floor=1e-6):
    """The module docstring's tolerances on x, the step count and the
    residual series (each a (buffer, nvalid) pair), compared above ``floor``
    |r0|."""
    xp, xj = to_numpy(xp), np.asarray(xj)
    if dtype == F64:
        assert int(itp) == int(itj)
        rp = to_numpy(logp[0])[: int(logp[1])]
        rj = np.asarray(logj[0])[: int(logj[1])]
        big = rj > floor * r0
        np.testing.assert_allclose(rp[big], rj[big], rtol=1e-8)
        assert rel(xp, xj) <= 1e-10
    else:
        assert abs(int(itp) - int(itj)) <= 2
        assert rel(xp, xj) <= 1e-4


def _core_inputs(A, dtype, x0, jacobi, reltol):
    n = A.shape[0]
    b = _vec(n, dtype, 3)
    x0v = (0.1 * _vec(n, dtype, 9)).astype(dtype) if x0 else np.zeros(
        n, dtype)
    Pl = (6.0 * (1 + 0.5 * np.random.default_rng(4).random(n))).astype(
        dtype) if jacobi else None
    jt = jtols(np.dtype(dtype), reltol, None)
    pt = ptols(to_torch(b).dtype, reltol, None)
    return b, x0v, Pl, jt, pt


# ---- BiCGStab(l) ------------------------------------------------------------


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("l", [1, 2, 4])
@pytest.mark.parametrize("op", ["advection_diffusion(6)",
                                "advection_diffusion_stencil(6)"])
def test_bicgstabl_core_matches_jax(op, l, dtype):
    """The same shadow residual (numpy, uniform) in both cores; the product
    count in steps of 2l."""
    A = OPS[op](dtype)
    n = A.shape[0]
    b, x0, _, jt, pt = _core_inputs(A, dtype, False, False,
                                    1e-9 if dtype == F64 else 1e-5)
    rs = np.random.default_rng(11).random(n).astype(dtype)
    max_mv = 4 * n
    resj, mvj = jbi._bicgstabl_jit(A, b, x0, jprec(None), rs, *jt, l=l,
                                   max_mv=max_mv, initially_zero=True)
    resp, mvp = pbi._bicgstabl_core(_port(A), to_torch(b), to_torch(x0),
                                    pprec(None, device=CPU), to_torch(rs),
                                    *pt, l, max_mv, True)
    assert bool(resp.converged) and bool(resj.converged)
    assert int(mvp) == 2 * l * int(resp.iters)
    if dtype == F64:
        assert int(mvp) == int(mvj)
    _compare(resp.x, resp.iters, resp.log["resnorm"], resj.x, resj.iters,
             resj.log["resnorm"], dtype, float(np.linalg.norm(b)))


@pytest.mark.parametrize("case", ["jacobi_warm_x0", "complex"])
def test_bicgstabl_core_preconditioned_and_complex_match_jax(case):
    """Left Jacobi preconditioning from a warm start on laplace_dia(6, 3);
    and a complex dense system with a complex shadow residual (f64)."""
    if case == "complex":
        rng = np.random.default_rng(2)
        n = 30
        M = rng.random((n, n)) + 1j * rng.random((n, n)) + n * np.eye(n)
        b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        rs = rng.random(n) + 1j * rng.random(n)
        x0 = np.zeros(n, complex)
        jA, pA, Pj, Pp = M, pits.MatrixOperator(to_torch(M)), None, None
    else:
        A = OPS["laplace_dia(6,3)"](F64)
        n = A.shape[0]
        b, x0, Pl, _, _ = _core_inputs(A, F64, True, True, 1e-9)
        rs = np.random.default_rng(11).random(n)
        jA, pA, Pj, Pp = A, _port(A), Pl, to_torch(Pl)
    dt = np.result_type(b.dtype, np.float64)
    jt, pt = jtols(dt, 1e-9, None), ptols(to_torch(b).dtype, 1e-9, None)
    jop = jits.as_operator(jA, b)
    resj, mvj = jbi._bicgstabl_jit(jop, b, x0, jprec(Pj), rs, *jt, l=2,
                                   max_mv=2000, initially_zero=False)
    resp, mvp = pbi._bicgstabl_core(pA, to_torch(b), to_torch(x0),
                                    pprec(Pp, device=CPU), to_torch(rs), *pt,
                                    2, 2000, False)
    assert int(mvp) == int(mvj)
    r0 = float(np.linalg.norm(b))
    _compare(resp.x, resp.iters, resp.log["resnorm"], resj.x, resj.iters,
             resj.log["resnorm"], F64, r0)


def test_bicgstabl_draws_its_shadow_from_a_seeded_generator():
    """``bicgstabl(seed=s)`` is the core with ``random_like`` of a CPU
    generator seeded s; it solves the system; its history counts the
    products; and the iterator, stepped to its end, gives the same x."""
    A = _port(OPS["advection_diffusion(6)"](F64))
    b = _vec(A.shape[0], F64, 3)
    x, h = pits.bicgstabl(A, b, 2, seed=5, reltol=1e-10, log=True)
    rs = random_like(torch.Generator().manual_seed(5), (A.shape[0],),
                     torch.float64)
    res, mv = pbi._bicgstabl_core(A, to_torch(b), torch.zeros_like(rs),
                                  pprec(None, device=CPU), rs,
                                  *ptols(torch.float64, 1e-10, None), 2,
                                  A.shape[0], True)
    assert torch.equal(x, res.x) and h.mvps == int(mv) == 4 * h.iters
    r = to_torch(b) - A.mv(x)
    assert float(torch.linalg.vector_norm(r)) <= 1e-9 * np.linalg.norm(b)
    it = pits.bicgstabl_iterator(A, b, 2, seed=5, reltol=1e-10)
    assert sum(1 for _ in it) == h.iters
    assert rel(to_numpy(it.x), to_numpy(x)) <= 1e-12


# ---- IDR(s) ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("s", [1, 4, 8])
@pytest.mark.parametrize("op", ["advection_diffusion(6)",
                                "advection_diffusion_stencil(6)"])
def test_idrs_core_matches_jax(op, s, dtype):
    """The same shadow space P (s, n) (numpy, uniform) in both cores."""
    A = OPS[op](dtype)
    n = A.shape[0]
    b, x0, _, jt, pt = _core_inputs(A, dtype, False, False,
                                    1e-9 if dtype == F64 else 1e-5)
    P = np.random.default_rng(12).random((s, n)).astype(dtype)
    resj = jidrs._idrs_jit(A, b, x0, jprec(None), P, *jt, s=s, maxiter=4 * n,
                           smoothing=False, initially_zero=True)
    resp = pidrs._idrs_core(_port(A), to_torch(b), to_torch(x0),
                            pprec(None, device=CPU), to_torch(P), *pt, s,
                            4 * n, False, True)
    assert bool(resp.converged) and bool(resj.converged)
    _compare(resp.x, resp.iters, resp.log["resnorm"], resj.x, resj.iters,
             resj.log["resnorm"], dtype, float(np.linalg.norm(b)))


@pytest.mark.parametrize("case", ["smoothing", "jacobi_warm_x0"])
def test_idrs_core_smoothing_and_preconditioned_match_jax(case):
    """Residual smoothing (the smoothed iterate returned) and left Jacobi
    preconditioning from a warm start, IDR(4), f64."""
    A = OPS["advection_diffusion(6)" if case == "smoothing"
             else "laplace_dia(6,3)"](F64)
    n = A.shape[0]
    warm = case != "smoothing"
    b, x0, Pl, jt, pt = _core_inputs(A, F64, warm, warm, 1e-9)
    P = np.random.default_rng(12).random((4, n))
    smoothing = case == "smoothing"
    resj = jidrs._idrs_jit(A, b, x0, jprec(Pl), P, *jt, s=4, maxiter=4 * n,
                           smoothing=smoothing, initially_zero=not warm)
    resp = pidrs._idrs_core(_port(A), to_torch(b), to_torch(x0),
                            pprec(None if Pl is None else to_torch(Pl),
                                  device=CPU), to_torch(P), *pt, 4, 4 * n,
                            smoothing, not warm)
    _compare(resp.x, resp.iters, resp.log["resnorm"], resj.x, resj.iters,
             resj.log["resnorm"], F64, float(np.linalg.norm(b)))


def test_idrs_draws_its_shadow_space_and_iterates():
    """``idrs(seed=s)`` is the core with ``random_like`` (s, n) of a CPU
    generator seeded s; it solves the system; the iterator, stepped to its
    end (its step's kind read from the state), gives the same x; and the
    solve's x does not depend on ``chunk`` (the host's count of the step
    kind across phases)."""
    A = _port(OPS["advection_diffusion_stencil(6)"](F64))
    b = _vec(A.shape[0], F64, 3)
    x, h = pits.idrs(A, b, s=4, seed=6, reltol=1e-10, log=True)
    P = random_like(torch.Generator().manual_seed(6), (4, A.shape[0]),
                    torch.float64)
    res = pidrs._idrs_core(A, to_torch(b), torch.zeros(A.shape[0],
                                                       dtype=torch.float64),
                           pprec(None, device=CPU), P,
                           *ptols(torch.float64, 1e-10, None), 4, A.shape[0],
                           False, True)
    assert torch.equal(x, res.x) and h.mvps == h.iters
    r = to_torch(b) - A.mv(x)
    assert float(torch.linalg.vector_norm(r)) <= 1e-9 * np.linalg.norm(b)
    for chunk in (1, 8):
        xc = pits.idrs(A, b, s=4, seed=6, reltol=1e-10, chunk=chunk)
        assert torch.equal(xc, x)
    it = pits.idrs_iterator(A, b, s=4, seed=6, reltol=1e-10)
    assert sum(1 for _ in it) == h.iters
    assert rel(to_numpy(it.x), to_numpy(x)) <= 1e-12


# ---- the power method ----------------------------------------------------------


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("op", ["laplace_dia(6,3)", "laplacian(6,3)"])
def test_powm_matches_jax(op, dtype):
    """From the same real start vector, 60 steps at tol 0 (f64) or to the
    default tol (f32): the Rayleigh quotient within 1e-10 (f64) or 1e-5
    (f32) relative, and the steps and x as the module docstring."""
    A = (OPS[op] if op in OPS else
         (lambda dt: jits.laplacian(6, 3, dtype=dt)))(dtype)
    x0 = _vec(A.shape[0], dtype, 13)
    x0 = (x0 / np.linalg.norm(x0)).astype(dtype)
    kw = dict(maxiter=60, tol=0.0, log=True) if dtype == F64 else dict(
        maxiter=400, log=True)
    lj, xj, hj = jits.powm(A, x0=x0, **kw)
    lp, xp, hp = pits.powm(_port(A), x0=to_torch(x0), **kw)
    assert abs(float(lp) - float(lj)) <= (1e-10 if dtype == F64 else 1e-5) * (
        abs(float(lj)))
    assert hp.mvps == hp.iters and hp["tol"] == hj["tol"]
    _compare(xp, hp.iters, (torch.as_tensor(hp["resnorm"]), hp.iters), xj,
             hj.iters, (hj["resnorm"], hj.iters), dtype, 1.0, floor=1e-12)


def test_invpowm_and_default_start_match_jax():
    """Inverse iteration on (A - 0.5 I)^{-1} as a dense matrix from the same
    start: the eigenvalue of laplace_dia(4, 2) nearest 0.5; and from each
    package's own random complex start, powm reaches the dominant
    eigenvalue 20 of a diagonal matrix (the next 10) to 1e-10."""
    A = np.asarray(jfix.laplace_dia(4, 2, dtype=F64).to_dense())
    B = np.linalg.inv(A - 0.5 * np.eye(16))
    x0 = _vec(16, F64, 14)
    lj, xj = jits.invpowm(B, shift=0.5, x0=x0, tol=1e-13, maxiter=200)
    lp, xp = pits.invpowm(to_torch(B), shift=0.5, x0=to_torch(x0),
                          tol=1e-13, maxiter=200)
    want = min(np.linalg.eigvalsh(A), key=lambda v: abs(v - 0.5))
    assert abs(float(lp) - want) <= 1e-10 and abs(float(lj) - want) <= 1e-10
    d = np.concatenate([np.linspace(1.0, 10.0, 40), [20.0]])
    D = jits.DIAMatrix(d[None, :], (0,), (41, 41))
    lj, _ = jits.powm(D, tol=1e-12, maxiter=300)
    lp, xp = pits.powm(port_dia(D), tol=1e-12, maxiter=300,
                       key=torch.Generator().manual_seed(1))
    assert xp.dtype == torch.complex128
    assert abs(complex(lp) - 20) <= 1e-10 and abs(complex(lj) - 20) <= 1e-10
    it = pits.powm_iterator(port_dia(D), to_torch(_vec(41, F64, 2)),
                            tol=1e-12, maxiter=300)
    for _ in it:
        pass
    assert abs(float(it.state.theta) - 20) <= 1e-10
