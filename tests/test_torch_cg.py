"""The port's CG (``iterativesolvers_tpu_torch/solvers/cg.py``) against the
JAX package's on the same inputs, and its driver contract.

f64: the same iteration and product counts, the residual series and x within
1e-10 relative.  f32: iteration counts within 2, both converged, x within
1e-4 relative (sums are taken in another order).
"""

import numpy as np
import pytest
import torch

import iterativesolvers_tpu as jits
from iterativesolvers_tpu.utils import fixtures as jfix

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.solvers.common import chunked_steps
from iterativesolvers_tpu_torch.utils import fixtures as pfix

from _torch_port import CPU, port_dia, port_stencil, rel, to_numpy, to_torch

torch.set_num_threads(1)

OPS = {
    "laplace_dia(16,3)": lambda dt: jfix.laplace_dia(16, 3, dtype=dt),
    "laplacian(16,3)": lambda dt: jits.laplacian(16, 3, dtype=dt),
}


def _port(A):
    return port_dia(A) if isinstance(A, jits.DIAMatrix) else port_stencil(A)


def _inputs(case, n, dtype, seed=7):
    r = np.random.default_rng(seed)
    b = r.standard_normal(n).astype(dtype)
    kw = {}
    if case == "jacobi":
        kw["Pl"] = (6.0 * (1.0 + 0.5 * r.random(n))).astype(dtype)
    elif case == "warm_x0":
        kw["x0"] = r.standard_normal(n).astype(dtype)
    return b, kw


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["plain", "jacobi", "warm_x0"])
@pytest.mark.parametrize("op", list(OPS))
def test_cg_matches_jax(op, case, dtype):
    A = OPS[op](dtype)
    n = A.shape[0]
    b, kw = _inputs(case, n, dtype)
    xj, hj = jits.cg(A, b, log=True, **kw)
    xp, hp = pits.cg(_port(A), b, log=True, **kw)
    assert xp.device == torch.device(CPU)
    assert xp.dtype == to_torch(b).dtype
    assert hp.isconverged and hj.isconverged
    if dtype == np.float64:
        assert (hp.iters, hp.mvps, hp.mtvps) == (hj.iters, hj.mvps, hj.mtvps)
        np.testing.assert_allclose(hp["resnorm"], hj["resnorm"], rtol=1e-10)
        assert rel(to_numpy(xp), xj) <= 1e-10
    else:
        assert abs(hp.iters - hj.iters) <= 2
        assert rel(to_numpy(xp), xj) <= 1e-4
    assert hp["reltol"] == hj["reltol"] and hp["abstol"] == hj["abstol"]
    assert hp.mvps == hp.iters + ("x0" in kw)
    assert len(hp["resnorm"]) == hp.iters


def test_cg_counters_tolerances_and_return_forms():
    P = pfix.laplace_dia(6, 2, device=CPU)
    A = jfix.laplace_dia(6, 2)
    b = np.ones(36)
    x = pits.cg(P, b, abstol=1e-3, reltol=0.0)
    assert isinstance(x, torch.Tensor) and x.shape == (36,)
    for kw in ({"maxiter": 0}, {"maxiter": 3}, {"abstol": 1e-3, "reltol": 0.0}):
        _, hp = pits.cg(P, b, log=True, **kw)
        _, hj = jits.cg(A, b, log=True, **kw)
        assert (hp.iters, hp.mvps, hp.isconverged) == (
            hj.iters, hj.mvps, hj.isconverged)
        assert hp["abstol"] == hj["abstol"] and hp["reltol"] == hj["reltol"]
        # b = ones meets only 5 eigenvalues: the 5th residual is rounding
        np.testing.assert_allclose(hp["resnorm"], hj["resnorm"], rtol=1e-10,
                                   atol=1e-14)


def test_cg_iterator_matches_cg_and_old_states_stay_checkpoints(rng):
    P = pfix.laplace_dia(10, 2, device=CPU)
    b = to_torch(rng.standard_normal(100))
    x, h = pits.cg(P, b, log=True)
    it = pits.cg_iterator(P, b)
    res, saved = [], None
    for k, r in enumerate(it):
        res.append(float(r))
        if k == 2:
            saved = it.state
            frozen = [t.clone() for t in saved]
    assert len(res) == h.iters
    np.testing.assert_array_equal(res, h["resnorm"])
    assert torch.equal(it.x, x)
    # stepping on never wrote the tensors of the state held at step 3
    assert all(torch.equal(a, f) for a, f in zip(saved, frozen))
    resumed = pits.cg_iterator(P, b)
    resumed.state = saved
    for _ in resumed:
        pass
    assert torch.equal(resumed.x, x)


def test_cg_iterator_matches_jax_iterator(rng):
    A = jfix.laplace_dia(8, 2)
    b = rng.standard_normal(64)
    got = [float(r) for r in pits.cg_iterator(port_dia(A), b)]
    want = [float(r) for r in jits.cg_iterator(A, b)]
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("op", list(OPS))
def test_run_chunked_numerics_do_not_depend_on_chunk(op):
    P = _port(OPS[op](np.float32))
    b = np.random.default_rng(3).standard_normal(P.shape[0]).astype(np.float32)
    runs = [pits.cg(P, b, log=True, chunk=c) for c in (1, 8, 256)]
    x1, h1 = runs[0]
    for x, h in runs[1:]:
        assert torch.equal(x, x1)
        assert h.iters == h1.iters
        np.testing.assert_array_equal(h["resnorm"], h1["resnorm"])


def test_run_chunked_step_counts_follow_the_warmup_ladder():
    """Phases of 8, 16, 32, 64, 128, then ``chunk``: the bench's 248- and
    504-step solves stop exactly at maxiter."""
    assert [chunked_steps(k) for k in (0, 1, 8, 9, 248, 249, 504, 505)] == [
        0, 8, 8, 24, 248, 504, 504, 760]
    assert chunked_steps(20, chunk=8) == 24 and chunked_steps(5, 1) == 5
    d = torch.linspace(1.0, 10.0, 1000, dtype=torch.float64)
    calls = []

    def mv(v):
        calls.append(1)
        return d * v

    op = pits.FunctionOperator(mv, (1000, 1000), torch.float64, device=CPU)
    b = torch.ones(1000, dtype=torch.float64)
    for maxiter, chunk in ((248, 256), (504, 256), (20, 8), (20, 1)):
        calls.clear()
        x, h = pits.cg(op, b, reltol=0.0, abstol=0.0, maxiter=maxiter,
                       chunk=chunk, log=True)
        assert h.iters == maxiter
        assert len(calls) == chunked_steps(maxiter, chunk)
        if chunk == 8:
            x8 = x
    assert torch.equal(x, x8)
