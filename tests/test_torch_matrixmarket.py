"""The MatrixMarket pipeline of the port (native parse -> CSR -> format pick
-> solver) against the JAX package's, on the CPU, on the committed corpus
``benchmarks/matrices/*.mtx`` (the workloads of
tests/test_matrixmarket_workloads.py and benchmarks/run_all.py:711-800).

Parsing, loading and the format pick give equal arrays and the same class
and perm.  The solves run in f64 beside the JAX package's, and each is held
to the bars tests/test_matrixmarket_workloads.py states and to the JAX
package's own spread: most of these systems amplify rounding (CG on the FEM
Poisson matrix departs from the JAX package's own run with b moved by
1e-15 relative after ~30 steps, its step count by 1-3), so the residual
series is held within 1e-10 relative over the steps where the JAX package
against itself (b times 1 +- 1e-15) agrees within 1e-12, the step count
within 4 times that spread plus 2, and x within 4 times its spread plus
1e-12.
"""

import pathlib

import numpy as np
import pytest
import torch

import iterativesolvers_tpu as jits
from iterativesolvers_tpu import native as jnative
from iterativesolvers_tpu.operators.preconditioners import (
    DiagonalPreconditioner as JacobiJax)
from iterativesolvers_tpu.operators.sparse import BSRMatrix as BSRJax

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch import native as pnative

from _torch_port import CPU, rel, to_numpy

torch.set_num_threads(1)

MDIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / \
    "matrices"
FILES = ("fem_poisson", "mesh_gradient_ls", "elasticity_2d", "fd_band9",
         "powerlaw_graph", "uniform_scatter")
# the formats the JAX package picks (tests/test_matrixmarket_workloads.py)
PICKS = {"fem_poisson": "HYBMatrix", "mesh_gradient_ls": "ELLMatrix",
         "elasticity_2d": "DIAMatrix", "fd_band9": "DIAMatrix",
         "powerlaw_graph": "HYBMatrix", "uniform_scatter": "ELLMatrix"}


def _path(name):
    return str(MDIR / f"{name}.mtx")


def _load(name, dtype=np.float64):
    return (jits.load_matrix_market(_path(name), dtype=dtype),
            pits.load_matrix_market(_path(name), dtype=dtype, device=CPU))


@pytest.mark.parametrize("name", FILES)
def test_mm_read_corpus_matches_python_and_jax(name):
    """The native parse equals the Python parser and the JAX package's on
    each committed file; loading gives the JAX package's CSR arrays in f64
    and f32."""
    shape, rows, cols, vals = pnative.mm_read(_path(name))
    for want in (pnative._mm_read_python(_path(name)),
                 jnative.mm_read(_path(name))):
        assert shape == tuple(want[0])
        for a, b in zip((rows, cols, vals), want[1:]):
            np.testing.assert_array_equal(a, np.asarray(b, a.dtype))
    for dt in (np.float64, np.float32):
        jA, pA = _load(name, dt)
        assert pA.dtype == torch.from_numpy(np.zeros(0, dt)).dtype
        for key in ("data", "indices", "indptr", "row_ids"):
            np.testing.assert_array_equal(to_numpy(getattr(pA, key)),
                                          np.asarray(getattr(jA, key)))


@pytest.mark.parametrize("name", FILES)
def test_auto_format_on_corpus_matches_jax(name):
    jA, pA = _load(name)
    jop, jperm = jA.auto_format()
    pop, pperm = pA.auto_format()
    assert type(pop).__name__ == type(jop).__name__ == PICKS[name]
    assert pperm is None and jperm is None
    x = np.random.default_rng(0).standard_normal(jA.shape[1])
    assert rel(to_numpy(pop.mv(torch.from_numpy(x))),
               np.asarray(jop.mv(x))) <= 1e-12


def _series(h):
    key = "resnorm" if "resnorm" in h.data else "rnorm"
    return np.asarray(h[key])


def check_against_jax(port, jax, b):
    """Run ``jax(b)``, ``jax`` on b moved by +-1e-15 relative and
    ``port(b)`` (f64); hold the port to the module docstring's limits.
    Returns the port's (x, history)."""
    xj, hj = jax(b)
    variants = [jax(b * (1 + s)) for s in (1e-15, -1e-15)]
    xp, hp = port(torch.from_numpy(np.array(b)))
    rj, rp = _series(hj), _series(hp)
    stable = rj.size
    for _, hv in variants:
        rv = _series(hv)
        m = min(rv.size, rj.size)
        off = np.abs(rv[:m] - rj[:m]) > 1e-12 * np.abs(rj[:m])
        stable = min(stable, int(np.argmax(off)) if off.any() else m)
    assert rp.size >= stable
    np.testing.assert_allclose(rp[:stable], rj[:stable], rtol=1e-10)
    spread_iters = max(abs(hv.iters - hj.iters) for _, hv in variants)
    assert abs(hp.iters - hj.iters) <= 4 * spread_iters + 2
    spread_x = max(rel(np.asarray(xv), np.asarray(xj)) for xv, _ in variants)
    assert rel(to_numpy(xp), np.asarray(xj)) <= 4 * spread_x + 1e-12
    assert hp.isconverged == hj.isconverged
    return to_numpy(xp), hp


def _true_res(A, x, b):
    return float(np.linalg.norm(np.asarray(A.mv(x)) - b) / np.linalg.norm(b))


def _jacobi(jA, pA):
    d, present = jA.diagonal()
    pd, ppresent = pA.diagonal()
    assert present.all() and bool(ppresent.all())
    np.testing.assert_array_equal(to_numpy(pd), d)
    return JacobiJax(d), pits.DiagonalPreconditioner(pd, device=CPU)


def test_poisson_cg_jacobi_hyb_matches_jax():
    """CG with the Jacobi preconditioner on the FEM Poisson matrix in HYB
    form (the JAX package's test: converged, true residual below 1e-6,
    fewer than 2500 steps)."""
    jA, pA = _load("fem_poisson")
    jP, pP = _jacobi(jA, pA)
    b = np.asarray(jA.mv(np.random.default_rng(1).standard_normal(
        jA.shape[0])))
    jh, ph = jA.to_hyb(), pA.to_hyb()
    kw = dict(reltol=1e-8, maxiter=3000, log=True)
    x, h = check_against_jax(lambda b: pits.cg(ph, b, Pl=pP, **kw),
                             lambda b: jits.cg(jh, b, Pl=jP, **kw), b)
    assert h.isconverged and h.iters < 2500
    assert _true_res(jA, x, b) < 1e-6


def test_poisson_gmres_jacobi_hyb_matches_jax():
    """GMRES(60) with the Jacobi preconditioner on the same matrix (true
    residual below 1e-3: the preconditioned residual is the one held)."""
    jA, pA = _load("fem_poisson")
    jP, pP = _jacobi(jA, pA)
    b = np.random.default_rng(2).standard_normal(jA.shape[0])
    jh, ph = jA.to_hyb(), pA.to_hyb()
    kw = dict(reltol=1e-5, restart=60, maxiter=3000, log=True)
    x, h = check_against_jax(lambda b: pits.gmres(ph, b, Pl=pP, **kw),
                             lambda b: jits.gmres(jh, b, Pl=jP, **kw), b)
    assert h.isconverged and _true_res(jA, x, b) < 1e-3


@pytest.mark.parametrize("solver", ["lsqr", "lsmr"])
def test_gradient_least_squares_hyb_matches_jax(solver):
    """LSQR and LSMR on the mesh gradient in HYB form with its adjoint, a
    consistent system (converged, true residual below 1e-6)."""
    jG, pG = _load("mesh_gradient_ls")
    jo, po = jG.to_hyb().with_adjoint(), pG.to_hyb().with_adjoint()
    b = np.asarray(jG.mv(np.random.default_rng(3).standard_normal(
        jG.shape[1])))
    kw = dict(atol=1e-10, btol=1e-10, maxiter=2000, log=True)
    x, h = check_against_jax(lambda b: getattr(pits, solver)(po, b, **kw),
                             lambda b: getattr(jits, solver)(jo, b, **kw), b)
    assert h.isconverged and _true_res(jG, x, b) < 1e-6


def test_elasticity_cg_bsr_matches_jax():
    """CG with the Jacobi preconditioner on the 2-dof elasticity matrix in
    BSR(2) form (converged, true residual below 1e-5), whose block product
    agrees with the CSR one."""
    jE, pE = _load("elasticity_2d")
    jP, pP = _jacobi(jE, pE)
    jb, pb = BSRJax.from_csr(jE, 2), pits.BSRMatrix.from_csr(pE, 2)
    assert pE.nnz / pb.nnz > 0.8
    b = np.random.default_rng(4).standard_normal(jE.shape[0])
    assert rel(to_numpy(pb.mv(torch.from_numpy(b))),
               to_numpy(pE.mv(torch.from_numpy(b)))) <= 1e-12
    kw = dict(reltol=1e-7, maxiter=6000, log=True)
    x, h = check_against_jax(lambda b: pits.cg(pb, b, Pl=pP, **kw),
                             lambda b: jits.cg(jb, b, Pl=jP, **kw), b)
    assert h.isconverged and _true_res(jE, x, b) < 1e-5


@pytest.mark.parametrize("name", ["fd_band9", "powerlaw_graph",
                                  "uniform_scatter"])
def test_auto_format_solves_match_jax(name):
    """The solves of tests/test_matrixmarket_workloads.py through the picked
    format: CG on the DIA band and the HYB power-law graph, GMRES(20) on
    the ELL scatter (converged, true residual below 1e-4)."""
    jA, pA = _load(name)
    (jo, _), (po, _) = jA.auto_format(), pA.auto_format()
    n = jA.shape[0]
    if name == "fd_band9":
        b = np.asarray(jA.mv(np.random.default_rng(5).standard_normal(n)))
        kw = dict(reltol=1e-8, maxiter=4000, log=True)
        solve = "cg"
    elif name == "powerlaw_graph":
        b, kw, solve = np.ones(n), dict(reltol=1e-6, maxiter=2000,
                                        log=True), "cg"
    else:
        b, kw, solve = np.ones(n), dict(restart=20, reltol=1e-6,
                                        maxiter=400, log=True), "gmres"
    x, h = check_against_jax(lambda b: getattr(pits, solve)(po, b, **kw),
                             lambda b: getattr(jits, solve)(jo, b, **kw), b)
    assert h.isconverged and _true_res(jA, x, b) < 1e-4
