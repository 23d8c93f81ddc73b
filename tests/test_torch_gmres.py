"""The port's GMRES (``iterativesolvers_tpu_torch/solvers/gmres.py``) against
the JAX package's ``gmres`` on the same inputs, its kernel routes and its
iterator.

f64 and complex128: the same iteration, product and restart counts, the
residual series and x within 1e-10 relative.  f32: iteration counts within 1
and x within 1e-4 relative (sums are taken in another order; the port's f32
MGS runs through the panel kernels' plain versions on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterativesolvers_tpu as jits
from iterativesolvers_tpu.solvers import gmres as jgmres_mod
from iterativesolvers_tpu.utils import fixtures as jfix

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.ops import cuda_mgs
from iterativesolvers_tpu_torch.solvers import gmres as pgmres_mod

from _torch_port import CPU, port_dia, port_stencil, rel, to_numpy, to_torch

torch.set_num_threads(1)


def rtol_for(dtype):
    return float(np.sqrt(np.finfo(np.zeros((), dtype).real.dtype).eps))


def general_matrix(rng, n, dtype):
    a = rng.random((n, n))
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.random((n, n))
    return a.astype(dtype) + np.eye(n, dtype=dtype)


def _port_pre(M):
    """An exact preconditioner in the port: a solve with the dense M (the
    JAX side passes ``DensePreconditioner(M)``, not ported yet)."""
    Mt = to_torch(M)
    return pits.FunctionPreconditioner(
        lambda v: torch.linalg.solve(Mt, v.to(Mt.dtype)))


def _match_f64(jx, jh, px, ph):
    assert (ph.iters, ph.mvps, ph.restarts, ph.isconverged) == (
        jh.iters, jh.mvps, jh.restarts, jh.isconverged)
    # atol: a residual at rounding level (an exact preconditioner's first
    # step) carries no relative digits; every b here is of norm ~1
    np.testing.assert_allclose(ph["resnorm"], jh["resnorm"], rtol=1e-10,
                               atol=1e-13)
    assert rel(to_numpy(px), np.asarray(jx)) <= 1e-10
    assert ph["reltol"] == jh["reltol"] and ph["abstol"] == jh["abstol"]
    assert len(ph["resnorm"]) == ph.iters


def _both(A, b, pA=None, **kw):
    """The same solve in JAX and in the port (``pA``: the port's operator,
    else the dense ``A`` as a CPU tensor); keyword values that are
    preconditioners come as ``(jax, port)`` pairs."""
    jkw = {k: (v[0] if isinstance(v, tuple) else v) for k, v in kw.items()}
    pkw = {k: (v[1] if isinstance(v, tuple) else v) for k, v in kw.items()}
    jx, jh = jits.gmres(A, b, log=True, **jkw)
    pA = to_torch(A) if pA is None else pA
    px, ph = pits.gmres(pA, to_torch(b), log=True, **pkw)
    return jx, jh, px, ph


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_gmres_general_matrix_matches_jax(rng, dtype):
    A = general_matrix(rng, 10, dtype)
    b = rng.random(10).astype(dtype)
    jx, jh, px, ph = _both(A, b, restart=3, maxiter=10,
                           reltol=rtol_for(dtype))
    _match_f64(jx, jh, px, ph)
    assert px.dtype == to_torch(b).dtype and px.device == torch.device(CPU)


@pytest.mark.parametrize("side", ["Pl", "Pr"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_gmres_exact_preconditioner_matches_jax(rng, dtype, side):
    A = general_matrix(rng, 10, dtype)
    b = rng.random(10).astype(dtype)
    pre = (jits.DensePreconditioner(jnp.asarray(A)), _port_pre(A))
    jx, jh, px, ph = _both(A, b, maxiter=1, restart=1,
                           reltol=rtol_for(dtype), **{side: pre})
    assert ph.isconverged
    _match_f64(jx, jh, px, ph)


def test_gmres_matrix_free_cumsum_matches_jax():
    n = 100
    b = np.random.default_rng(5).random(n)
    jop = jits.FunctionOperator(lambda v: jnp.cumsum(v), (n, n), np.float64)
    pop = pits.FunctionOperator(lambda v: torch.cumsum(v, 0), (n, n),
                                torch.float64, device=CPU)
    jx, jh, px, ph = _both(jop, b, pA=pop, reltol=1e-5, maxiter=2000)
    _match_f64(jx, jh, px, ph)
    assert ph.isconverged and ph.restarts >= 1


def test_gmres_identity_happy_breakdown_matches_jax():
    A = np.eye(2)
    b = np.array([1.0, 2.2])
    jx, jh, px, ph = _both(A, b)
    _match_f64(jx, jh, px, ph)
    np.testing.assert_allclose(to_numpy(px), b, rtol=1e-14)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_gmres_termination_criteria_match_jax(dtype):
    A = np.array([[2, -1, 0], [-1, 2, -1], [0, -1, 2]], dtype=dtype)
    b = np.ones(3, dtype=dtype)
    x0 = np.linalg.solve(A, b)
    eps = np.finfo(np.zeros((), dtype).real.dtype).eps
    x = x0 + 10 * np.sqrt(eps) * np.array([-1.0, 1.0, -1.0]).astype(dtype)
    jx, jh, px, ph = _both(A, b, x0=(jnp.asarray(x), to_torch(x)))
    _match_f64(jx, jh, px, ph)
    assert 1 <= ph.iters <= 4 and ph.mvps == ph.iters + 1 + ph.restarts + 1
    r0 = np.linalg.norm(A @ x - b)
    jx, jh, px, ph = _both(A, b, x0=(jnp.asarray(x), to_torch(x)),
                           abstol=2 * r0, reltol=0.0)
    _match_f64(jx, jh, px, ph)
    assert (ph.iters, ph.mvps, ph.restarts) == (0, 1, 0)


@pytest.mark.parametrize("orth", ["mgs", "cgs", "cgs2", "dgks"])
def test_gmres_orth_methods_match_jax(rng, orth):
    A = general_matrix(rng, 20, np.float64)
    b = rng.random(20)
    jx, jh, px, ph = _both(A, b, orth_method=orth, reltol=1e-10, maxiter=100)
    _match_f64(jx, jh, px, ph)
    assert np.linalg.norm(A @ to_numpy(px) - b) / np.linalg.norm(b) <= 1e-9


def test_gmres_restarts_match_jax(rng):
    A = general_matrix(rng, 50, np.float64) + 5 * np.eye(50)
    b = rng.random(50)
    jx, jh, px, ph = _both(A, b, restart=5, maxiter=500, reltol=1e-8)
    _match_f64(jx, jh, px, ph)
    assert ph.isconverged and ph.restarts >= 1


def test_gmres_maxiter_zero_and_converged_start_match_jax(rng):
    A = general_matrix(rng, 6, np.float64)
    b = rng.random(6)
    for kw in ({"maxiter": 0}, {"x0": (jnp.asarray(np.linalg.solve(A, b)),
                                       to_torch(np.linalg.solve(A, b)))}):
        jx, jh, px, ph = _both(A, b, **kw)
        assert (ph.iters, ph.mvps, ph.restarts, ph.isconverged) == (
            jh.iters, jh.mvps, jh.restarts, jh.isconverged)


F32_OPS = {
    "laplace_dia(16,3)": lambda: jfix.laplace_dia(16, 3, dtype=np.float32),
    "laplacian(16,3)": lambda: jits.laplacian(16, 3, dtype=np.float32),
}


def _port(A):
    return port_dia(A) if isinstance(A, jits.DIAMatrix) else port_stencil(A)


@pytest.mark.parametrize("panel", ["f32", "bf16"])
@pytest.mark.parametrize("op", list(F32_OPS))
def test_gmres_f32_matches_jax(op, panel):
    """reltol 3e-5: the two solutions differ by about reltol (bf16 panel:
    1.9e-4 at 1e-4, 9e-5 at 3e-5), and at 1e-5 a bf16-panel solve of JAX
    takes 55 steps against the port's 53, a gap that rounding alone opens
    in either package (test_gmres_bf16_panel_tight_tol_steps_move_with_
    rounding; ROADMAP Queue C)."""
    A = F32_OPS[op]()
    b = np.random.default_rng(7).standard_normal(A.shape[0]).astype(np.float32)
    pd = (jnp.bfloat16, torch.bfloat16) if panel == "bf16" else (None, None)
    jx, jh, px, ph = _both(A, b, pA=_port(A), restart=20, reltol=3e-5,
                           maxiter=2000, panel_dtype=pd)
    assert jh.isconverged and ph.isconverged
    assert abs(ph.iters - jh.iters) <= 1
    assert rel(to_numpy(px), np.asarray(jx)) <= 1e-4
    assert px.dtype == torch.float32
    r = np.linalg.norm(to_numpy(_port(A).mv(px)) - b) / np.linalg.norm(b)
    assert r <= 6e-5


def _ir_solve(pkg, A, b, maxiter=2000):
    """A bf16-panel GMRES-IR solve to reltol 1e-6 (below the bf16 floor) in
    the JAX package (``pkg = "jax"``) or the port; returns (x, history)."""
    kw = dict(restart=20, reltol=1e-6, maxiter=maxiter, log=True)
    if pkg == "jax":
        return jits.gmres(A, b, panel_dtype=jnp.bfloat16, **kw)
    return pits.gmres(port_dia(A), to_torch(b), panel_dtype=torch.bfloat16,
                      **kw)


@pytest.mark.parametrize("side", [64, 32])
def test_gmres_ir_stall_exit_matches_jax(side):
    """Below the bf16 basis floor the IR mode exits through the stall
    detector (converged=False) in both packages, with the true residual at
    the floor (the bounds of tests/test_gmres.py::test_bf16_panel_stall_exit).

    Up to the floor the two runs agree (the residual estimates of the first
    40 steps within 1e-4; bf16 rounding of the rows moves them by ~1e-5),
    and the port's floor is no higher than JAX's (within 1.2x: 5.2e-6
    against 4.7e-6 on 32^2; on 64^2 the port's is the lower).
    The step at which the detector fires is held to 4 cycles, not to +-1:
    at the floor the true residual moves by rounding alone from cycle to
    cycle, and two cycles without 0.1% progress come at another cycle when
    the rounding differs.  The witness is the next test: in each package a
    rounding-level change of b moves the exit by cycles, or past maxiter."""
    A = jfix.laplace_dia(side, 2, dtype=np.float32)
    b = np.ones(A.shape[0], np.float32)
    P = port_dia(A)
    jx, jh = _ir_solve("jax", A, b)
    px, ph = _ir_solve("port", A, b)
    assert not jh.isconverged and not ph.isconverged
    assert ph.iters < 2000 and jh.iters < 2000
    assert abs(ph.iters - jh.iters) <= 4 * 20
    np.testing.assert_allclose(ph["resnorm"][:40], jh["resnorm"][:40],
                               rtol=1e-4)
    r, rj = (np.linalg.norm(to_numpy(P.mv(to_torch(np.asarray(x)))) - b)
             / np.linalg.norm(b) for x in (to_numpy(px), jx))
    assert r < 1e-4 and rj < 1e-4
    assert r <= 1.2 * rj
    _, hp = pits.gmres(P, to_torch(b), restart=20, reltol=1e-6,
                       maxiter=200, panel_dtype=torch.bfloat16,
                       ir_stall_exit=False, log=True)
    assert hp.iters == 200


@pytest.mark.parametrize("pkg,scales", [
    ("jax", (0.0, 2.0**-20, 3 * 2.0**-20)),
    ("port", (0.0, -2.0**-20)),
])
def test_gmres_ir_stall_exit_step_moves_with_rounding(pkg, scales):
    """On laplace_dia(32,2) a change of b by 2^-20 relative (8 f32 steps of
    1) moves the IR stall exit of either package by cycles, or keeps it
    from firing at all: at the bf16 floor the per-cycle true residual
    wanders by a few percent, and whether two cycles in a row lose less
    than 0.1% is a matter of rounding.  JAX: 261 steps at b = 1, 210 at
    1 + 2^-20, maxiter at 1 + 3 * 2^-20; the port: 214 at b = 1, maxiter at
    1 - 2^-20 (no exit in 2000 steps; maxiter 600 here, since a solve is
    the same up to its maxiter).  So a run to maxiter where the other
    package stalls, or exits some cycles apart, is rounding, in the
    reference as in the port."""
    A = jfix.laplace_dia(32, 2, dtype=np.float32)
    steps = []
    for s in scales:
        b = np.full(A.shape[0], 1 + s, np.float32)
        _, h = _ir_solve(pkg, A, b, maxiter=600)
        assert not h.isconverged
        steps.append(h.iters)
    exits = [k for k in steps if k < 600]
    assert exits and len(exits) < len(steps), steps
    if len(exits) > 1:
        assert max(exits) - min(exits) >= 2 * 20, steps


def test_gmres_bf16_panel_tight_tol_steps_move_with_rounding():
    """The bf16-panel solve of test_gmres_f32_matches_jax at reltol 1e-5
    takes 55 steps in JAX and 53 in the port at the test's b; with b scaled
    by 1 + s, s in {2^-20, -2^-20, 3 * 2^-20} (a few f32 steps of each
    entry), JAX takes 54, 54, 53 and the port 55, 53, 54.  So each package's
    count spans 53-55 by rounding alone and the other's count lies in that
    span: the gap is rounding, not a systematic difference (ROADMAP
    Queue C)."""
    A = jfix.laplace_dia(16, 3, dtype=np.float32)
    P = port_dia(A)
    b0 = np.random.default_rng(7).standard_normal(A.shape[0]).astype(np.float32)
    kw = dict(restart=20, reltol=1e-5, maxiter=2000, log=True)
    steps = {"jax": [], "port": []}
    for s in (0.0, 2.0**-20, -2.0**-20, 3 * 2.0**-20):
        b = (b0 * np.float32(1 + s)).astype(np.float32)
        _, jh = jits.gmres(A, b, panel_dtype=jnp.bfloat16, **kw)
        _, ph = pits.gmres(P, to_torch(b), panel_dtype=torch.bfloat16, **kw)
        assert jh.isconverged and ph.isconverged
        steps["jax"].append(jh.iters)
        steps["port"].append(ph.iters)
    for pkg, other in (("jax", "port"), ("port", "jax")):
        assert max(steps[pkg]) - min(steps[pkg]) >= 2, steps
        assert min(steps[pkg]) <= steps[other][0] <= max(steps[pkg]), steps


def test_gmres_pallas_interpret_route_matches_port(monkeypatch):
    """JAX GMRES through its Pallas panel-MGS kernel in interpret mode (as
    tests/test_pallas.py runs it) against the port's panel-MGS route on
    the same shifted 1-D Laplacian of 4 * 262144 rows."""
    import iterativesolvers_tpu.ops.pallas_mgs as pm

    n = 4 * 262144
    main = np.full(n, 4.0, np.float32)
    up = np.full(n, -1.0, np.float32)
    up[-1] = 0.0
    lo = np.full(n, -1.0, np.float32)
    lo[0] = 0.0
    A = jits.DIAMatrix((main, up, lo), (0, 1, -1), (n, n))
    b = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    monkeypatch.setattr(pm, "_INTERPRET", True)
    monkeypatch.setattr(jgmres_mod, "_use_panel_mgs", lambda *a: True)
    jx = jits.gmres(A, jnp.asarray(b), restart=2, maxiter=4, reltol=1e-6)
    calls = []
    step = cuda_mgs.panel_mgs
    monkeypatch.setattr(pgmres_mod, "panel_mgs",
                        lambda *a: calls.append(1) or step(*a))
    px = pits.gmres(port_dia(A), to_torch(b), restart=2, maxiter=4,
                    reltol=1e-6)
    assert len(calls) == 4
    assert rel(to_numpy(px), np.asarray(jx)) <= 1e-5


def _shifted(side=12, shift=7.0):
    St = pits.laplacian(side, 3, device=CPU)
    return pits.StencilOperator(St.n, shift, St.terms, St.coeffs, device=CPU)


def _record(monkeypatch, calls):
    for mod, name in ((pgmres_mod, "fused_arnoldi"),
                      (pgmres_mod, "stencil_panel_mv"),
                      (pgmres_mod, "panel_mgs"),
                      (pgmres_mod, "orthogonalize_and_normalize_rows")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _f=fn, _n=name: calls.append(_n)
                            or _f(*a))


def test_gmres_routes_follow_the_dispatch_rule(monkeypatch):
    """The JAX rule without its TPU gates: fused on an unpreconditioned f32
    stencil with an f32 panel; panel SpMV + panel MGS with a bf16 panel;
    op.mv + panel MGS on any other real f32 MGS solve (a preconditioned
    stencil too: its product goes through the preconditioners); plain
    PyTorch for f64 and for other orthogonalizations.  Each step calls its
    route once, masked steps included: ``restart`` steps a cycle."""
    St = _shifted()
    D = St.to_dia()
    b = torch.ones(St.n)
    jacobi = torch.full((St.n,), 7.0)
    cases = [
        (St, {}, {"fused_arnoldi"}),
        (St, {"panel_dtype": torch.bfloat16},
         {"stencil_panel_mv", "panel_mgs"}),
        (D, {}, {"panel_mgs"}),
        (D, {"panel_dtype": torch.bfloat16}, {"panel_mgs"}),
        (St, {"Pl": jacobi}, {"panel_mgs"}),
        (St, {"orth_method": "cgs2"}, {"orthogonalize_and_normalize_rows"}),
        (D.astype(torch.float64), {}, {"orthogonalize_and_normalize_rows"}),
    ]
    for op, kw, want in cases:
        calls = []
        _record(monkeypatch, calls)
        x, h = pits.gmres(op, b, restart=5, maxiter=20, reltol=1e-5,
                          log=True, **kw)
        assert set(calls) == want, (kw, set(calls))
        assert len(calls) == len(want) * 5 * (h.restarts + 1), kw
        monkeypatch.undo()


@pytest.mark.parametrize("panel", [torch.float32, torch.bfloat16])
def test_gmres_kernel_routes_match_their_witness(monkeypatch, panel):
    """The kernel routes (plain versions here) against the same solve with
    the kernels routed off through the dispatch functions: plain PyTorch
    orthogonalization and op.mv, the witness chip_smoke.py also runs."""
    St = _shifted()
    b = torch.from_numpy(
        np.random.default_rng(3).standard_normal(St.n).astype(np.float32))
    for op in (St, St.to_dia()):
        x, h = pits.gmres(op, b, restart=6, reltol=1e-5, log=True,
                          panel_dtype=panel)
        with monkeypatch.context() as mp:
            mp.setattr(pgmres_mod, "_fused_setup", lambda *a: None)
            mp.setattr(pgmres_mod, "_stencil_panel_setup", lambda *a: None)
            mp.setattr(pgmres_mod, "_use_panel_mgs", lambda *a: False)
            xw, hw = pits.gmres(op, b, restart=6, reltol=1e-5, log=True,
                                panel_dtype=panel)
        assert h.isconverged and hw.isconverged and h.restarts >= 1
        assert abs(h.iters - hw.iters) <= 1
        assert rel(to_numpy(x), to_numpy(xw)) <= 1e-4


def test_gmres_panel_dtype_auto_validation_and_verbose(capsys):
    St = _shifted(side=6)
    b = torch.ones(St.n)
    xa, ha = pits.gmres(St, b, reltol=1e-6, log=True, verbose=True)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == ha.iters
    assert lines[0].split()[0] == "1"
    np.testing.assert_allclose([float(s.split()[1]) for s in lines],
                               ha["resnorm"], rtol=1e-2)
    x32, h32 = pits.gmres(St, b, reltol=1e-6, log=True, panel_dtype=None)
    assert torch.equal(xa, x32) and ha.iters == h32.iters
    with pytest.raises(ValueError, match="bfloat16 panels on float32"):
        pits.gmres(St.to_dia().astype(torch.float64), b.double(),
                   panel_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="orthogonalization method"):
        pits.gmres(St, b, orth_method="householder")


def test_gmres_iterator_matches_gmres_and_old_states_stay_checkpoints(rng):
    A = to_torch(general_matrix(rng, 30, np.float64))
    b = to_torch(rng.random(30))
    x, h = pits.gmres(A, b, restart=4, maxiter=40, reltol=1e-10, log=True)
    it = pits.gmres_iterator(A, b, restart=4, maxiter=40, reltol=1e-10)
    res, saved = [], None
    for k, r in enumerate(it):
        res.append(float(r))
        if k == 5:
            saved = it.state
            frozen = [t.clone() for t in saved]
    assert len(res) == h.iters and h.restarts >= 2
    np.testing.assert_allclose(res, h["resnorm"], rtol=1e-12)
    assert rel(to_numpy(it.x), to_numpy(x)) <= 1e-12
    # stepping on never wrote the tensors of the state held at step 6
    assert all(torch.equal(a, f) for a, f in zip(saved, frozen))
    resumed = pits.gmres_iterator(A, b, restart=4, maxiter=40, reltol=1e-10)
    resumed.state = saved
    for _ in resumed:
        pass
    assert torch.equal(resumed.x, it.x)


def test_gmres_iterator_matches_jax_iterator(rng):
    A = general_matrix(rng, 12, np.float64)
    b = rng.random(12)
    got = [float(r) for r in pits.gmres_iterator(to_torch(A), to_torch(b),
                                                 restart=5, reltol=1e-10)]
    want = [float(r) for r in jits.gmres_iterator(A, b, restart=5,
                                                  reltol=1e-10)]
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_gmres_iterator_f32_stencil_takes_the_fused_route(monkeypatch):
    St = _shifted(side=6)
    b = torch.ones(St.n)
    calls = []
    _record(monkeypatch, calls)
    x, h = pits.gmres(St, b, restart=5, reltol=1e-5, log=True)
    calls.clear()
    it = pits.gmres_iterator(St, b, restart=5, reltol=1e-5)
    n = sum(1 for _ in it)
    assert n == h.iters and set(calls) == {"fused_arnoldi"}
    assert len(calls) == n
    assert rel(to_numpy(it.x), to_numpy(x)) <= 1e-5
