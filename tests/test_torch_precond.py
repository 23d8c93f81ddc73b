"""The port's preconditioners (``ops/triangular.py``, the ILU / IC /
red-black preconditioners of ``operators/preconditioners.py``,
``operators/rb_reduce.py``) against the JAX package on the CPU, in f64.

Tolerances: the level arrays of ``from_csr`` equal the JAX package's; the
multicolor permutation and ``nlevels`` equal; ``ldiv``, ``mv`` and the
transforms within 1e-12 relative (the sums of a row or a shift pass run in
another order); solves take equal steps with residual series within 1e-10
relative.  Each guard raises the JAX package's exception type.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterativesolvers_tpu as jits
from iterativesolvers_tpu.operators import preconditioners as jprec
from iterativesolvers_tpu.operators.rb_reduce import RBReducedSystem as JRB
from iterativesolvers_tpu.operators.sparse import CSRMatrix as JCSR
from iterativesolvers_tpu.operators.sparse import DIAMatrix as JDIA
from iterativesolvers_tpu.operators.sparse import csr_from_dense as jcsr_dense
from iterativesolvers_tpu.ops.triangular import LevelScheduledTriangular as JLT
from iterativesolvers_tpu.utils import fixtures as jfix

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.operators.sparse import CSRMatrix as PCSR
from iterativesolvers_tpu_torch.operators.sparse import DIAMatrix as PDIA
from iterativesolvers_tpu_torch.ops.triangular import level_arrays

from _torch_port import (CPU, port_dia, port_precond, port_sparse,
                         port_stencil, rel, to_numpy, to_torch)

torch.set_num_threads(1)

F64 = np.float64


def _close(got, want, tol=1e-12):
    got, want = to_numpy(got), np.asarray(want)
    assert got.shape == want.shape
    assert rel(got, want) <= tol, rel(got, want)


def _csr_arrays(csr):
    return (np.asarray(csr.indptr), np.asarray(csr.indices),
            np.asarray(csr.data))


# ---- LevelScheduledTriangular ----------------------------------------------

def _random_triangle(lower, n=40, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.random((n, n))
    M = np.tril(M, -1) if lower else np.triu(M, 1)
    M[np.abs(M) < 0.7] = 0.0
    return jcsr_dense(M), rng.random(n) + 1.0


def _laplace_triangle(lower):
    A = jfix.laplace_dia(6, 3, dtype=F64).to_csr()
    rows, cols, vals = (np.asarray(A.row_ids), np.asarray(A.indices),
                        np.asarray(A.data))
    m = rows > cols if lower else rows < cols
    return JCSR.from_coo(rows[m], cols[m], vals[m], A.shape), np.full(216, 6.)


TRIANGLES = {"random lower": lambda: _random_triangle(True),
             "random upper": lambda: _random_triangle(False),
             "laplace 6^3 lower": lambda: _laplace_triangle(True),
             "laplace 6^3 upper": lambda: _laplace_triangle(False)}


@pytest.mark.parametrize("name", list(TRIANGLES))
def test_triangular_from_csr_equals_jax_and_solves(name):
    csr, d = TRIANGLES[name]()
    lower = "lower" in name
    ip, ix, dt = _csr_arrays(csr)
    J = JLT.from_csr(ip, ix, dt, d, lower)
    rows, cols, vals = level_arrays(ip, ix, dt, d.size, lower)
    for got, want in ((rows, J.rows), (cols, J.cols), (vals, J.vals)):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))
    P = pits.LevelScheduledTriangular.from_csr(ip, ix, dt, d, lower,
                                               device=CPU)
    assert P.nlevels == J.nlevels
    rng = np.random.default_rng(1)
    rhs = rng.standard_normal(d.size)
    _close(P.solve(to_torch(rhs)), J.solve(jnp.asarray(rhs)))
    _close(P.solve(to_torch(rhs), omega=1.3),
           J.solve(jnp.asarray(rhs), omega=1.3))
    om = torch.tensor(0.7, dtype=torch.float64)
    _close(P.solve(to_torch(rhs), omega=om),
           J.solve(jnp.asarray(rhs), omega=jnp.asarray(0.7)))
    panel = rng.standard_normal((3, d.size))
    _close(P.solve(to_torch(panel)),
           jax.vmap(J.solve)(jnp.asarray(panel)))


@pytest.mark.parametrize("case", ["complex diag", "f32 values, f64 rhs",
                                  "f32, omega f64 tensor"])
def test_triangular_solve_promotes_like_jax(case):
    csr, d = _random_triangle(True, n=24, seed=3)
    ip, ix, dt = _csr_arrays(csr)
    rhs = np.random.default_rng(4).standard_normal(24)
    omega = None
    if case == "complex diag":
        d = d + 0.5j
    elif case == "f32 values, f64 rhs":
        dt, d = dt.astype(np.float32), d.astype(np.float32)
    else:
        dt, d, rhs = (dt.astype(np.float32), d.astype(np.float32),
                      rhs.astype(np.float32))
        omega = 1.2
    J = JLT.from_csr(ip, ix, dt, d, True)
    P = pits.LevelScheduledTriangular.from_csr(ip, ix, dt, d, True,
                                               device=CPU)
    want = J.solve(jnp.asarray(rhs),
                   omega=None if omega is None else jnp.asarray(omega, F64))
    got = P.solve(to_torch(rhs), omega=None if omega is None else
                  torch.tensor(omega, dtype=torch.float64))
    assert to_numpy(got).dtype == np.asarray(want).dtype
    _close(got, want, 1e-12 if np.asarray(want).dtype != np.float32
           else 1e-6)


# ---- ILU(0) / IC(0) --------------------------------------------------------

MATRICES = {
    "laplace 10^3": lambda: jfix.laplace_dia(10, 3, dtype=F64).to_csr(),
    "variable diffusion 12^2": lambda: jfix.variable_diffusion(
        12, 2, contrast=1e3, seed=3, dtype=F64).to_csr(),
    "advection-diffusion 8^3": lambda: jfix.advection_diffusion(
        8, dtype=F64)[0].to_csr(),
}
FACTORS = [(k, m, o) for k in ("ilu", "ic") for m in MATRICES
           for o in ("natural", "multicolor")
           if not (k == "ic" and m.startswith("advection"))]


def _factor(kind):
    return {"ilu": (jprec.ILUPreconditioner, pits.ILUPreconditioner),
            "ic": (jprec.ICPreconditioner, pits.ICPreconditioner)}[kind]


@pytest.mark.parametrize("kind,matrix,ordering", FACTORS)
def test_factor_matches_jax(kind, matrix, ordering):
    """The factors' level arrays, the permutation and nlevels equal the JAX
    package's (its factor values within 1e-14: the native pass is built
    apart); ldiv and the row-panel apply within 1e-12."""
    csr = MATRICES[matrix]()
    Jc, Pc = _factor(kind)
    J = Jc.from_operator(csr, ordering=ordering)
    P = Pc.from_operator(port_sparse(csr), ordering=ordering)
    assert P.nlevels == J.nlevels
    if ordering == "multicolor":
        np.testing.assert_array_equal(to_numpy(P.perm), np.asarray(J.perm))
        np.testing.assert_array_equal(to_numpy(P.inv), np.asarray(J.inv))
    else:
        assert P.perm is None and J.perm is None
    for pt, jt in ((P.lower_solve, J.lower_solve),
                   (P.upper_solve, J.upper_solve)):
        np.testing.assert_array_equal(to_numpy(pt.cols), np.asarray(jt.cols))
        np.testing.assert_array_equal(to_numpy(pt.rows), np.asarray(jt.rows))
        np.testing.assert_allclose(to_numpy(pt.vals), np.asarray(jt.vals),
                                   rtol=1e-14, atol=1e-14)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(csr.shape[0])
    _close(P.ldiv(to_torch(x)), J.ldiv(jnp.asarray(x)))
    X = rng.standard_normal((3, csr.shape[0]))
    _close(P.ldiv_rows(to_torch(X)), J.ldiv_rows(jnp.asarray(X)))


def _hermitian_pd(n, seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    M[np.abs(M) < 1.6] = 0.0
    M = M + M.conj().T
    M[np.diag_indices(n)] = np.abs(M).sum(axis=1) + 1.0
    return M


@pytest.mark.parametrize("kind,ordering", [("ilu", "natural"),
                                           ("ilu", "multicolor"),
                                           ("ic", "natural")])
def test_complex_factor_matches_jax(kind, ordering):
    """Complex factors take the numpy factorizations in both packages."""
    M = _hermitian_pd(30, 5)
    if kind == "ilu":
        M = M + np.triu(0.3j * (M != 0), 1)      # not Hermitian
    csr = jcsr_dense(M)
    Jc, Pc = _factor(kind)
    J = Jc.from_operator(csr, ordering=ordering)
    P = Pc.from_operator(port_sparse(csr), ordering=ordering)
    rng = np.random.default_rng(6)
    x = rng.standard_normal(30) + 1j * rng.standard_normal(30)
    got = P.ldiv(to_torch(x))
    assert got.dtype == torch.complex128
    _close(got, J.ldiv(jnp.asarray(x)))


def test_block_jacobi_ilu_matches_jax():
    csr = MATRICES["advection-diffusion 8^3"]()
    J = jprec.ILUPreconditioner.block_jacobi(csr, 8)
    P = pits.ILUPreconditioner.block_jacobi(port_sparse(csr), 8)
    assert P.nlevels == J.nlevels
    x = np.random.default_rng(7).standard_normal(csr.shape[0])
    _close(P.ldiv(to_torch(x)), J.ldiv(jnp.asarray(x)))


# ---- the red-black preconditioners and the reduced system ------------------

def _vd(side, dims, **kw):
    return jfix.variable_diffusion(side, dims, contrast=kw.pop("contrast",
                                                                1e3),
                                   seed=kw.pop("seed", 3), dtype=F64, **kw)


RBIC = {
    "stencil laplacian 9^3": lambda: ("stencil", jits.laplacian(9, 3, dtype=F64),
                                      {}),
    "stencil laplacian 8^2 shift 0.5": lambda: (
        "stencil", jits.laplacian(8, 2, dtype=F64), {"shift": 0.5}),
    "dia variable diffusion 9^3 aniso": lambda: (
        "dia", _vd(9, 3, aniso=(1, 1, 30)), {"side": 9, "dims": 3}),
    "dia variable diffusion 8^2": lambda: (
        "dia", _vd(8, 2), {"side": 8, "dims": 2}),
}


@pytest.mark.parametrize("name", list(RBIC))
def test_redblack_ic_matches_jax(name):
    form, A, kw = RBIC[name]()
    if form == "stencil":
        J = jprec.RedBlackICPreconditioner.from_stencil(A, **kw)
        P = pits.RedBlackICPreconditioner.from_stencil(port_stencil(A), **kw)
    else:
        J = jprec.RedBlackICPreconditioner.from_dia(A, **kw)
        P = pits.RedBlackICPreconditioner.from_dia(port_dia(A), **kw)
    assert P.terms == tuple(J.terms)
    np.testing.assert_array_equal(to_numpy(P.red), np.asarray(J.red))
    _close(P.s_inv, J.s_inv)
    for pm, jm in zip(P.mcs, J.mcs):
        np.testing.assert_array_equal(to_numpy(pm), np.asarray(jm))
    n = P.s_inv.shape[0]
    rng = np.random.default_rng(8)
    x = rng.standard_normal(n)
    _close(P.ldiv(to_torch(x)), J.ldiv(jnp.asarray(x)))
    X = rng.standard_normal((n, 2))                  # columns, as JAX ldiv
    _close(P.ldiv(to_torch(X)), J.ldiv(jnp.asarray(X)))
    _close(P.ldiv_rows(to_torch(X.T)), J.ldiv_rows(jnp.asarray(X.T)))


@pytest.mark.parametrize("side,dims", [(7, 2), (6, 3)])
def test_eisenstat_matches_jax(side, dims):
    A = _vd(side, dims, contrast=100, seed=5)
    J = jprec.EisenstatSSOROperator.from_dia(A, side, dims)
    P = pits.EisenstatSSOROperator.from_dia(port_dia(A), side, dims)
    assert P.shape == J.shape and P.terms == tuple(J.terms)
    _close(P.s, J.s)
    for pm, jm in zip(P.mcs, J.mcs):
        _close(pm, jm)
    rng = np.random.default_rng(9)
    v = rng.standard_normal(A.shape[0])
    vj, vt = jnp.asarray(v), to_torch(v)
    _close(P.mv(vt), J.mv(vj))
    _close(P.rmv(vt), J.rmv(vj))
    _close(P.rhs_transform(vt), J.rhs_transform(vj))
    _close(P.solution_transform(vt), J.solution_transform(vj))


@pytest.mark.parametrize("side,dims", [(8, 2), (6, 3)])
def test_rb_reduced_matches_jax(side, dims):
    A = _vd(side, dims, contrast=100, seed=5)
    J = JRB.from_dia(A, side, dims)
    P = pits.RBReducedSystem.from_dia(port_dia(A), side, dims)
    assert (P.shape3, P.nh) == (tuple(J.shape3), J.nh)
    assert (P.sr_offsets, P.sb_offsets) == (tuple(J.sr_offsets),
                                            tuple(J.sb_offsets))
    for pc, jc in zip(P.sr_streams + P.sb_streams,
                      tuple(J.sr_streams) + tuple(J.sb_streams)):
        np.testing.assert_array_equal(to_numpy(pc), np.asarray(jc))
    rng = np.random.default_rng(10)
    v = rng.standard_normal(A.shape[0])
    for pv, jv in zip(P.split(to_torch(v)), J.split(jnp.asarray(v))):
        np.testing.assert_array_equal(to_numpy(pv), np.asarray(jv))
    r, b = P.split(to_torch(v))
    np.testing.assert_array_equal(to_numpy(P.merge(r, b)), v)
    vb = rng.standard_normal(J.nh)
    _close(P.to_red(to_torch(vb)), J.to_red(jnp.asarray(vb)))
    _close(P.to_black(to_torch(vb)), J.to_black(jnp.asarray(vb)))
    _close(P.mv(to_torch(vb)), J.mv(jnp.asarray(vb)))
    V = rng.standard_normal((J.nh, 3))
    _close(P.mv(to_torch(V)), J.mv(jnp.asarray(V)))
    for pv, jv in zip(P.reduce_rhs(to_torch(v)), J.reduce_rhs(jnp.asarray(v))):
        _close(pv, jv)
    _close(P.expand_solution(to_torch(vb), to_torch(vb[::-1].copy())),
           J.expand_solution(jnp.asarray(vb), jnp.asarray(vb[::-1])))
    Pd, Jd = P.to_dia(), J.to_dia()
    assert isinstance(Pd, PDIA) and Pd.offsets == tuple(Jd.offsets)
    for pd_, jd in zip(Pd.diags, Jd.diags):
        np.testing.assert_array_equal(to_numpy(pd_), np.asarray(jd))


# ---- solves: the slice as a whole ------------------------------------------

WIN_SIDE = 12


def _win_problem():
    """tpu_precond_win.py's problem at side 12, f64."""
    return jfix.variable_diffusion(WIN_SIDE, 3, contrast=1e4, smooth=2,
                                   seed=7, dtype=F64)


def _leg(pkg, A, leg, b):
    """One leg of benchmarks/tpu_precond_win.py in ``pkg`` (the JAX package
    or the port) on its own operator ``A``: (x, history)."""
    kw = dict(reltol=1e-10, maxiter=2000, log=True)
    device = {} if pkg is jits else {"device": CPU}
    if leg == "none":
        return pkg.cg(A, b, **kw)
    if leg == "jacobi":
        d, _ = A.diagonal()
        return pkg.cg(A, b, Pl=pkg.DiagonalPreconditioner(d, **device), **kw)
    if leg == "rbic":
        P = pkg.RedBlackICPreconditioner.from_dia(A, WIN_SIDE, 3)
        return pkg.cg(A, b, Pl=P, **kw)
    if leg == "eisenstat":
        Ah = pkg.EisenstatSSOROperator.from_dia(A, WIN_SIDE, 3)
        xh, h = pkg.cg(Ah, Ah.rhs_transform(b), **kw)
        return Ah.solution_transform(xh), h
    R = pkg.RBReducedSystem.from_dia(A, WIN_SIDE, 3)
    bb, br = R.reduce_rhs(b)
    xb, h = pkg.cg(R.to_dia() if leg == "rb_reduced to_dia" else R, bb, **kw)
    return R.expand_solution(xb, br), h


def _same_solve(got, want, xtol=1e-10, spread=None):
    """Equal steps, residual series within 1e-10 relative, x within
    ``xtol``.  With ``spread`` (the JAX package's own relative move of each
    residual under b (1 +- 1e-15)) the series' largest relative difference
    is held to twice the spread's largest instead, where that is larger."""
    (xp, hp), (xj, hj) = got, want
    assert hp.isconverged and hj.isconverged
    assert hp.iters == hj.iters
    rj = np.asarray(hj["resnorm"])
    diff = np.abs(np.asarray(hp["resnorm"]) - rj)
    if spread is None:
        assert np.all(diff <= 1e-10 * rj + 1e-12 * rj[0])
    else:
        assert np.max(diff / rj) <= max(1e-10, 2 * np.max(spread))
    assert rel(to_numpy(xp), np.asarray(xj)) <= xtol


@pytest.mark.parametrize("leg", ["none", "jacobi", "rbic", "eisenstat",
                                 "rb_reduced", "rb_reduced to_dia"])
def test_precond_win_legs_match_jax(leg):
    """Each leg of the 216^3 workload of benchmarks/tpu_precond_win.py, at
    side 12 in f64, through the port's own builders.  Unpreconditioned CG
    on this contrast-1e4 problem amplifies rounding in the JAX package
    itself (b (1 + 1e-15) moves its residual by up to ~17% near step 68 of
    82), so that leg's series is held to twice the JAX package's own spread
    where that is larger than 1e-10."""
    A = _win_problem()
    b = np.ones(A.shape[0])
    want = _leg(jits, A, leg, jnp.asarray(b))
    spread = None
    if leg == "none":
        rj = np.asarray(want[1]["resnorm"])
        spread = np.max([np.abs(np.asarray(
            _leg(jits, A, leg, jnp.asarray(b * f))[1]["resnorm"]) - rj) / rj
            for f in (1 + 1e-15, 1 - 1e-15)], axis=0)
    _same_solve(_leg(pits, port_dia(A), leg, to_torch(b)), want,
                spread=spread)


@pytest.mark.parametrize("ordering", ["natural", "multicolor"])
def test_ic_cg_matches_jax(ordering):
    csr = MATRICES["laplace 10^3"]()
    b = np.ones(csr.shape[0])
    J = jprec.ICPreconditioner.from_operator(csr, ordering=ordering)
    Pc = port_sparse(csr)
    P = pits.ICPreconditioner.from_operator(Pc, ordering=ordering)
    kw = dict(reltol=1e-10, maxiter=500, log=True)
    _same_solve(pits.cg(Pc, to_torch(b), Pl=P, **kw),
                jits.cg(csr, jnp.asarray(b), Pl=J, **kw))


@pytest.mark.parametrize("ordering", ["natural", "multicolor"])
def test_ilu_gmres_matches_jax(ordering):
    A, b = jfix.advection_diffusion(8, dtype=F64)
    csr = A.to_csr()
    J = jprec.ILUPreconditioner.from_operator(csr, ordering=ordering)
    P = pits.ILUPreconditioner.from_operator(port_sparse(csr),
                                             ordering=ordering)
    kw = dict(reltol=1e-9, restart=20, maxiter=400, log=True)
    _same_solve(pits.gmres(port_dia(A), to_torch(b), Pl=P, **kw),
                jits.gmres(A, jnp.asarray(b), Pl=J, **kw), xtol=1e-9)


# ---- guards ----------------------------------------------------------------

def _guard_cases():
    indefinite = np.diag([1.0, -1.0, 1.0])
    nodiag = (np.array([0, 1]), np.array([1, 0]), np.array([1.0, 1.0]))
    rect = np.ones((3, 4))
    bad_step = lambda pkg, dt: pkg.StencilOperator(  # noqa: E731
        64, 4.0, ((2, 1, 64), (-2, 1, 64)), (-1.0, -1.0), dtype=dt)
    n = 16
    off = -np.arange(1, n + 1, dtype=F64)
    asym = (np.stack([np.full(n, 40.0), off, np.roll(off * 2, 1)]),
            (0, 1, -1), (n, n))
    unit = (np.stack([np.ones(n) * 4, -np.ones(n), -np.ones(n)]), (0, 3, -3),
            (n, n))

    def dia(pkg, arrays):
        data, offs, shape = arrays
        if pkg is jits:
            return JDIA(data, offs, shape)
        return PDIA(list(data), offs, shape, device=CPU)

    def csr(pkg, M):
        return (jcsr_dense(M) if pkg is jits
                else pits.csr_from_dense(M, device=CPU))

    def vd(pkg, side, dims):
        A = jfix.variable_diffusion(side, dims, dtype=F64)
        return A if pkg is jits else port_dia(A)

    def cls(name):
        """The class ``name`` of a package (the JAX one's from its module)."""
        return lambda pkg: getattr(jprec if pkg is jits else pits, name)

    rbic, eis = cls("RedBlackICPreconditioner"), cls("EisenstatSSOROperator")
    ilu, ic = cls("ILUPreconditioner"), cls("ICPreconditioner")

    def red(pkg):
        return JRB if pkg is jits else pits.RBReducedSystem
    return {
        "ic indefinite": lambda pkg: ic(pkg).from_operator(
            csr(pkg, indefinite)),
        "ilu missing diagonal": lambda pkg: ilu(pkg).from_operator(
            (JCSR if pkg is jits else PCSR).from_coo(
                *nodiag, (2, 2), **({} if pkg is jits else {"device": CPU}))),
        "ilu rectangular": lambda pkg: ilu(pkg).from_operator(csr(pkg, rect)),
        "ic rectangular": lambda pkg: ic(pkg).from_operator(csr(pkg, rect)),
        "ilu unknown ordering": lambda pkg: ilu(pkg).from_operator(
            csr(pkg, np.eye(3)), ordering="rainbow"),
        "ic unknown ordering": lambda pkg: ic(pkg).from_operator(
            csr(pkg, np.eye(3)), ordering="rainbow"),
        "rbic non-unit step": lambda pkg: rbic(pkg).from_stencil(
            bad_step(pkg, F64) if pkg is jits else port_stencil(
                bad_step(jits, F64))),
        "rbic nonsymmetric stencil": lambda pkg: rbic(pkg).from_stencil(
            (lambda St: St if pkg is jits else port_stencil(St))(
                jits.advection_diffusion_stencil(8, dtype=F64))),
        "rbic not a stencil": lambda pkg: rbic(pkg).from_stencil(
            vd(pkg, 8, 2)),
        "rbic laplacian breakdown": lambda pkg: rbic(pkg).from_stencil(
            (lambda St: St if pkg is jits else port_stencil(St))(
                jits.laplacian(8, 2, dtype=F64)), shift=-4.0),
        "rbic from_dia side": lambda pkg: rbic(pkg).from_dia(vd(pkg, 8, 2),
                                                             7, 2),
        "rbic from_dia unit steps": lambda pkg: rbic(pkg).from_dia(
            dia(pkg, unit), 16, 1),
        "rbic from_dia not symmetric": lambda pkg: rbic(pkg).from_dia(
            dia(pkg, asym), 16, 1),
        "rbic from_dia not a DIA": lambda pkg: rbic(pkg).from_dia(
            csr(pkg, np.eye(4)), 2, 2),
        "eisenstat side": lambda pkg: eis(pkg).from_dia(vd(pkg, 8, 2), 7, 2),
        "eisenstat not symmetric": lambda pkg: eis(pkg).from_dia(
            dia(pkg, asym), 16, 1),
        "eisenstat non-positive diagonal": lambda pkg: eis(pkg).from_dia(
            dia(pkg, (-asym[0], asym[1], asym[2])), 16, 1),
        "rb_reduced odd side": lambda pkg: red(pkg).from_dia(vd(pkg, 9, 2),
                                                             9, 2),
        "rb_reduced not a DIA": lambda pkg: red(pkg).from_dia(
            csr(pkg, np.eye(4)), 2, 2),
    }


GUARDS = _guard_cases()


@pytest.mark.parametrize("name", list(GUARDS))
def test_guards_raise_like_jax(name):
    with pytest.raises(Exception) as want:
        GUARDS[name](jits)
    with pytest.raises(Exception) as got:
        GUARDS[name](pits)
    assert got.type is want.type, (got.value, want.value)
    assert got.type in (ZeroDivisionError, ValueError, TypeError)


# ---- carry-across and the surface ------------------------------------------

def _carried():
    A = _vd(8, 2)
    csr = A.to_csr()
    lower = jprec.ILUPreconditioner.from_operator(csr).lower_solve
    return {
        "triangular": lambda: (lower, lambda P, x: P.solve(x)),
        "ilu": lambda: (jprec.ILUPreconditioner.from_operator(
            csr, ordering="multicolor"), lambda P, x: P.ldiv(x)),
        "ic": lambda: (jprec.ICPreconditioner.from_operator(csr),
                       lambda P, x: P.ldiv(x)),
        "rbic": lambda: (jprec.RedBlackICPreconditioner.from_dia(A, 8, 2),
                         lambda P, x: P.ldiv(x)),
        "eisenstat": lambda: (jprec.EisenstatSSOROperator.from_dia(A, 8, 2),
                              lambda P, x: P.mv(x)),
        "rb_reduced": lambda: (JRB.from_dia(A, 8, 2),
                               lambda P, x: P.mv(P.reduce_rhs(x)[0])),
    }


@pytest.mark.parametrize("kind", ["triangular", "ilu", "ic", "rbic",
                                  "eisenstat", "rb_reduced"])
def test_carry_across_applies_like_jax(kind):
    """The JAX object's arrays rebuilt by ``utils/convert.py`` apply as the
    JAX object does."""
    J, apply = _carried()[kind]()
    P = port_precond(J)
    x = np.random.default_rng(11).standard_normal(64)
    _close(apply(P, to_torch(x)), apply(J, jnp.asarray(x)))


def test_exports_every_public_name_of_the_jax_package():
    names = {k for k in vars(jits) if not k.startswith("_")
             and not isinstance(getattr(jits, k), type(jits))}
    missing = sorted(k for k in names if not hasattr(pits, k))
    assert not missing, missing
    assert hasattr(pits.parallel, "ShardedBlockJacobiPreconditioner")
