"""The port's shared modules (``utils/dtypes.py``, ``utils/history.py``,
``solvers/common.py``) against the JAX package's, and the port's guards: it
imports no JAX, and its entry points run on the card unless asked.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativesolvers_tpu.solvers import common as jcommon
from iterativesolvers_tpu.utils import dtypes as jdtypes
from iterativesolvers_tpu.utils.history import ConvergenceHistory as JHistory

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.solvers import common as pcommon
from iterativesolvers_tpu_torch.utils import dtypes as pdtypes
from iterativesolvers_tpu_torch.utils.history import ConvergenceHistory

from _torch_port import to_torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _name(dt):
    return str(dt).removeprefix("torch.")


PAIRS = [("float32", "float32"), ("int8", "float32"), ("bfloat16", "float32"),
         ("float32", "float64"), ("float64", "float32"),
         ("complex64", "float32"), ("float64", "complex64"),
         ("complex128", "float64")]


@pytest.mark.parametrize("a,b", PAIRS)
def test_solve_dtype_matches_jax(a, b):
    want = jdtypes.solve_dtype(getattr(jnp, a), getattr(jnp, b))
    got = pdtypes.solve_dtype(getattr(torch, a), getattr(torch, b))
    assert _name(got) == np.dtype(want).name
    assert pdtypes.solve_dtype(np.dtype(a) if a != "bfloat16" else a,
                               np.dtype(b)) == got


@pytest.mark.parametrize("dt", ["float32", "float64", "complex64",
                                "complex128"])
def test_real_dtype_reltol_eps_zerox_match_jax(dt):
    assert _name(pdtypes.real_dtype(getattr(torch, dt))) == np.dtype(
        jdtypes.real_dtype(np.dtype(dt))).name
    assert pdtypes.default_reltol(dt) == jdtypes.default_reltol(np.dtype(dt))
    assert pdtypes.eps(dt) == jdtypes.eps(np.dtype(dt))
    A = pits.MatrixOperator(torch.eye(3, dtype=getattr(torch, dt)))
    z = pdtypes.zerox(A, torch.ones(3, dtype=torch.float32))
    assert z.dtype == torch.promote_types(getattr(torch, dt), torch.float32)
    assert not z.any()


def test_norm_vdot_tolerance_resolve_tols_match_jax(rng):
    a = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    b = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    np.testing.assert_allclose(float(pcommon.norm(to_torch(a))),
                               float(jcommon.norm(jnp.asarray(a))), rtol=1e-14)
    np.testing.assert_allclose(complex(pcommon.vdot(to_torch(a), to_torch(b))),
                               complex(jcommon.vdot(jnp.asarray(a),
                                                    jnp.asarray(b))),
                               rtol=1e-14)
    for reltol, abstol in ((None, None), (1e-3, None), (0.0, 1e-9)):
        for dt in ("float32", "complex128"):
            pr, pa = pcommon.resolve_tols(getattr(torch, dt), reltol, abstol)
            jr, ja = jcommon.resolve_tols(np.dtype(dt), reltol, abstol)
            assert (float(pr), float(pa)) == (float(jr), float(ja))
            assert _name(pr.dtype) == np.dtype(jr.dtype).name
            r0 = torch.tensor(2.5, dtype=pr.dtype)
            assert float(pcommon.tolerance(r0, pr, pa)) == float(
                jcommon.tolerance(jnp.asarray(2.5, jr.dtype), jr, ja))


def test_history_copy_behaves_like_jax(rng):
    buf = np.abs(rng.standard_normal(10))
    hs = []
    for cls in (ConvergenceHistory, JHistory):
        h = cls(partial=False, restart=4)
        h.iters, h.isconverged, h.mvps = 6, True, 7
        h.set_series("resnorm", buf, 6)
        h["reltol"] = 1e-6
        hs.append(h)
    p, j = hs
    assert repr(p) == repr(j)
    np.testing.assert_array_equal(p["resnorm"], j["resnorm"])
    assert ((p.niters(), p.nprods(), p.nrests())
            == (j.niters(), j.nprods(), j.nrests()))
    assert list(p.keys()) == list(j.keys()) and "reltol" in p
    assert p.plot() == j.plot()


def test_make_history_materializes_device_buffers():
    res = pcommon.SolveResult(
        x=torch.zeros(3), iters=torch.tensor(2), converged=torch.tensor(True),
        resnorm=torch.tensor(0.5),
        log={"resnorm": (torch.tensor([3.0, 0.5, 0.0]), torch.tensor(2))})
    h = pcommon.make_history(res, mv_per_iter=1.0, mv_initial=1,
                             extra_counters={"restarts": torch.tensor(1)})
    assert (h.iters, h.mvps, h.isconverged, h.restarts) == (2, 3, True, 1)
    np.testing.assert_array_equal(h["resnorm"], [3.0, 0.5])


def test_with_highest_precision_turns_tf32_off_and_restores():
    seen = []

    @pcommon.with_highest_precision
    def core():
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision()))
        raise KeyError("inside")

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(KeyError):
            core()
        assert seen == [(False, False, "highest")]
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before[:2]
        torch.set_float32_matmul_precision(before[2])


def test_run_chunked_freezes_state_at_done():
    """A toy step: the counter stops at 11 whatever the chunk."""
    def step(s, live):
        return s + live.to(s.dtype)

    def done(s):
        return s >= 11

    for chunk in (1, 2, 8, 256):
        out = pcommon.run_chunked(step, done, torch.tensor(0), chunk=chunk)
        assert int(out) == 11


def test_solver_iterator_protocol():
    it = pcommon.SolverIterator(torch.tensor(0), step=lambda s: s + 1,
                                done=lambda s: s >= 3, extract=lambda s: 10 * s,
                                get_x=lambda s: -s)
    assert [int(v) for v in it] == [10, 20, 30]
    assert int(it.x) == -3


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "iterativesolvers_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "tools").glob("*.py"))
    assert len(files) > 15
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "iterativesolvers_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_default_device_is_the_card():
    """``laplacian(8, 2)`` with the default device raises on a torch
    without CUDA: the port never runs quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this torch has CUDA: the default device works here")
    with pytest.raises((AssertionError, RuntimeError)):
        pits.laplacian(8, 2)
    with pytest.raises((AssertionError, RuntimeError)):
        pits.cg(pits.FunctionOperator(lambda v: v, (4, 4), "float32"),
                np.ones(4, np.float32))
