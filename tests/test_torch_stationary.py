"""The port's stationary methods (``solvers/stationary.py``) against the JAX
package on the CPU.

Contract: exactly ``maxiter`` sweeps, no convergence check.  x after the
sweeps within 1e-12 relative in f64 and complex128 (the port's sparse
product and level sweep sum each row in another order), 1e-5 in complex64;
the iterables step for step; each guard raises the JAX package's exception
type.
"""

import numpy as np
import pytest
import torch

import iterativesolvers_tpu as jits
from iterativesolvers_tpu.operators.sparse import CSRMatrix as JCSR
from iterativesolvers_tpu.operators.sparse import csr_from_dense as jcsr_dense
from iterativesolvers_tpu.solvers import stationary as jst
from iterativesolvers_tpu.utils import fixtures as jfix

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.solvers import stationary as pst

from _torch_port import CPU, port_sparse, rel, to_numpy

torch.set_num_threads(1)

METHODS = {"jacobi": (), "gauss_seidel": (), "sor": (1.1,), "ssor": (0.8,)}


def _dd(n, seed, dtype=np.float64):
    """Strictly diagonally dominant, sparse-ish, nonsymmetric."""
    rng = np.random.default_rng(seed)
    A = rng.random((n, n))
    A[A < 0.6] = 0.0
    if np.dtype(dtype).kind == "c":
        A = A + 1j * rng.random((n, n)) * (A != 0)
    A[np.diag_indices(n)] = 2.0 * np.abs(A).sum(axis=1) + 1.0
    return A.astype(dtype)


def _operands(form, A):
    """(JAX operand, port operand) of the dense matrix ``A`` in ``form``."""
    if form == "dense":
        return A, A
    csr = jcsr_dense(A)
    if form == "csr":
        return csr, port_sparse(csr)
    J = {"ell": csr.to_ell, "hyb": csr.to_hyb, "dia": csr.to_dia}[form]()
    return J, port_sparse(J)


def _tol(dtype):
    return 1e-5 if dtype == np.complex64 else 1e-12


CASES = [(m, f, o) for m in METHODS for f in ("dense", "csr")
         for o in ("natural", "multicolor")
         if not (m == "jacobi" and o == "multicolor")]


@pytest.mark.parametrize("method,form,ordering", CASES)
def test_sweeps_match_jax(method, form, ordering):
    A = _dd(30, 1)
    b = np.random.default_rng(2).random(30)
    Jop, Pop = _operands(form, A)
    args = METHODS[method]
    want = getattr(jits, method)(Jop, b, *args, maxiter=7, ordering=ordering)
    got = getattr(pits, method)(Pop, b, *args, maxiter=7, ordering=ordering,
                                device=CPU)
    assert rel(to_numpy(got), np.asarray(want)) <= 1e-12


@pytest.mark.parametrize("form", ["ell", "hyb", "dia"])
@pytest.mark.parametrize("method", ["gauss_seidel", "ssor"])
def test_stored_formats_match_jax(method, form):
    """DIA, ELL and HYB go through their CSR form, as in the JAX package;
    a warm start x0."""
    A = _dd(24, 3)
    A[np.abs(np.subtract.outer(np.arange(24), np.arange(24))) > 3] = 0.0
    b = np.random.default_rng(4).random(24)
    x0 = np.random.default_rng(5).random(24)
    Jop, Pop = _operands(form, A)
    args = METHODS[method]
    want = getattr(jits, method)(Jop, b, *args, x0=x0, maxiter=5)
    got = getattr(pits, method)(Pop, b, *args, x0=x0, maxiter=5)
    assert rel(to_numpy(got), np.asarray(want)) <= 1e-12


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("form", ["dense", "csr"])
@pytest.mark.parametrize("method", list(METHODS))
def test_complex_sweeps_match_jax(method, form, dtype):
    A = _dd(20, 6, dtype)
    rng = np.random.default_rng(7)
    b = (rng.random(20) + 1j * rng.random(20)).astype(dtype)
    Jop, Pop = _operands(form, A)
    args = METHODS[method]
    want = getattr(jits, method)(Jop, b, *args, maxiter=6)
    got = getattr(pits, method)(Pop, b, *args, maxiter=6, device=CPU)
    assert to_numpy(got).dtype == np.asarray(want).dtype
    assert rel(to_numpy(got), np.asarray(want)) <= _tol(dtype)


def test_sprand_workload_matches_jax():
    """benchmarks/run_all.py's stationary workload (sprand + 4I, 20 sweeps,
    every variant) at n = 2000, f64."""
    A = jfix.random_sparse(2000, 2000, 5.0 / 2000, seed=2, symmetrize=True,
                           shift=4.0)
    P = port_sparse(A)
    b = np.ones(2000)
    for name, args, kw in (("jacobi", (), {}), ("gauss_seidel", (), {}),
                           ("sor", (1.1,), {}), ("ssor", (1.1,), {}),
                           ("gauss_seidel", (), {"ordering": "multicolor"}),
                           ("sor", (1.1,), {"ordering": "multicolor"})):
        want = getattr(jits, name)(A, b, *args, maxiter=20, **kw)
        got = getattr(pits, name)(P, b, *args, maxiter=20, **kw)
        assert rel(to_numpy(got), np.asarray(want)) <= 1e-12, (name, kw)


@pytest.mark.parametrize("method", list(METHODS))
def test_iterables_step_like_jax(method):
    A = _dd(20, 8)
    b = np.random.default_rng(9).random(20)
    args = METHODS[method]
    jit_ = getattr(jits, f"{method}_iterable")(jcsr_dense(A), b, *args,
                                               maxiter=4)
    pit = getattr(pits, f"{method}_iterable")(
        pits.csr_from_dense(A, device=CPU), b, *args, maxiter=4)
    steps = 0
    for xj, xp in zip(jit_, pit):
        assert rel(to_numpy(xp), np.asarray(xj)) <= 1e-12
        steps += 1
    assert steps == 4 and int(pit.state.k) == 4
    with pytest.raises(StopIteration):
        next(pit)


def test_iterable_state_is_a_checkpoint():
    A = _dd(15, 10)
    b = np.random.default_rng(11).random(15)
    it = pits.jacobi_iterable(A, b, maxiter=50, device=CPU)
    for i, _ in enumerate(it):
        if i == 3:
            break
    x_mid = to_numpy(it.state.x)
    np.testing.assert_allclose(
        x_mid, np.asarray(jits.jacobi(A, b, maxiter=4)), rtol=1e-12)


def _guards():
    A = _dd(10, 12)
    sing = A.copy()
    sing[3, 3] = 0.0
    csr = jcsr_dense(A)
    rows, cols, vals = (np.asarray(csr.row_ids), np.asarray(csr.indices),
                        np.asarray(csr.data))
    keep = ~((rows == 5) & (cols == 5))
    b = np.ones(10)

    def op(pkg, M):
        return jcsr_dense(M) if pkg is jits else pits.csr_from_dense(
            M, device=CPU)

    def missing(pkg):
        if pkg is jits:
            return JCSR.from_coo(rows[keep], cols[keep], vals[keep], (10, 10))
        return pits.CSRMatrix.from_coo(rows[keep], cols[keep], vals[keep],
                                       (10, 10), device=CPU)

    dev = lambda pkg: {} if pkg is jits else {"device": CPU}  # noqa: E731
    return {
        "dense zero diagonal": lambda pkg: pkg.gauss_seidel(sing, b,
                                                            **dev(pkg)),
        "sparse zero diagonal": lambda pkg: pkg.sor(op(pkg, sing), b, 1.1),
        "jacobi dense zero diagonal": lambda pkg: pkg.jacobi(sing, b,
                                                             **dev(pkg)),
        "missing sparse diagonal": lambda pkg: pkg.gauss_seidel(missing(pkg),
                                                                b),
        "rectangular dense": lambda pkg: pkg.jacobi(np.ones((3, 4)),
                                                    np.ones(3), **dev(pkg)),
        "rectangular sparse": lambda pkg: pkg.jacobi(op(pkg, np.ones((3, 4))),
                                                     np.ones(3)),
        "unknown ordering": lambda pkg: pkg.sor(A, b, 1.1, ordering="rb",
                                                **dev(pkg)),
    }


GUARDS = _guards()


@pytest.mark.parametrize("name", list(GUARDS))
def test_guards_raise_like_jax(name):
    with pytest.raises(Exception) as want:
        GUARDS[name](jits)
    with pytest.raises(Exception) as got:
        GUARDS[name](pits)
    # the JAX package's SingularError is the port's SingularError here
    port_type = {jst.SingularError: pst.SingularError}.get(want.type,
                                                          want.type)
    assert got.type is port_type, (got.value, want.value)
    assert issubclass(got.type, ValueError)


def test_laplacian_sor_reduces_the_residual():
    """BASELINE workload 3's SOR leg: 200 sweeps of SOR(1.5) on the 16^2
    Laplacian in the port's DIA form, against the JAX package's x."""
    A = jfix.laplace_dia(16, 2)
    b = np.ones(256)
    want = np.asarray(jits.sor(A, b, 1.5, maxiter=200))
    got = to_numpy(pits.sor(port_sparse(A), b, 1.5, maxiter=200))
    assert rel(got, want) <= 1e-12
    M = np.asarray(A.to_dense())
    assert np.linalg.norm(M @ got - b) < np.linalg.norm(b)


def test_dense_f32_sweeps_take_no_tf32():
    """Dense f32 sweeps run with TF32 off (the JAX package pins the highest
    precision): the settings inside a sweep, restored after."""
    seen = []
    real = pst._mv_strict

    def spy(split, which, x):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return real(split, which, x)

    A = _dd(12, 13, np.float32)
    before = torch.get_float32_matmul_precision()
    pst._mv_strict = spy
    try:
        x = pits.gauss_seidel(A, np.ones(12, np.float32), maxiter=2,
                              device=CPU)
    finally:
        pst._mv_strict = real
    assert x.dtype == torch.float32
    assert seen and all(s == (False, "highest") for s in seen)
    assert torch.get_float32_matmul_precision() == before
    want = np.asarray(jits.gauss_seidel(A, np.ones(12, np.float32),
                                        maxiter=2))
    assert rel(to_numpy(x), want) <= 1e-6
