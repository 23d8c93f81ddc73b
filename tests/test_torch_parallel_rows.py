"""The rest of the port's distributed path against the JAX package on its
8-virtual-device CPU mesh: the halo operators' ``mv_rows``,
``RowShardedELLOperator``, ``DenseMeshOperator``, ``slice_mesh``,
``shard_dia`` / ``shard_ell``, the mesh forms of block CG, LSQR, LSMR,
LOBPCG and svdl, the collectives a step issues, and ``utils/profiling``.

Each case runs in D rank processes of ``tests/_torch_dist.py`` over gloo
on the CPU (all cases of one launch once for the module, as
``tests/test_torch_parallel.py`` runs them), the JAX side on ``row_mesh(D)``
or ``slice_mesh(2, 2)`` with the same D, on the same numpy inputs.  The JAX
package's svdl runs in a fresh interpreter of this file (XLA-CPU crashes
after a few hundred compilations in one process, ``tests/conftest.py``).

Tolerances: f64 rtol 1e-12 for products, 1e-10 for solutions, values and
residual series (equal step counts); f32 rtol 1e-6 with atol 1e-6 * max|y|
for products (the stencil kernel's interior sums in ascending offsets, the
JAX ``mv_rows`` in XLA's order), solutions within 1e-4 and step counts
within 2, as ``tests/test_torch_parallel.py`` holds them.
"""

import os
import subprocess
import sys
import types

import jax

if __name__ == "__main__":
    # script mode (the svdl references): the CPU and x64, as conftest sets
    # them, before the JAX package makes its first array
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import iterativesolvers_tpu as jits
from iterativesolvers_tpu.parallel import sharded as jsh
from iterativesolvers_tpu.utils import fixtures as jfix

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch import parallel as ppar
from iterativesolvers_tpu_torch.utils import convert, profiling

from _torch_dist import launch
from _torch_port import port_dia, port_stencil, rel, to_numpy, to_torch

PROCESS_TIMEOUT = 150

F64, F32 = np.float64, np.float32


# ---- operators: the JAX one, its port spec and arrays --------------------

def _stencil_spec(St):
    return {"kind": "stencil", "n": int(St.n), "center": float(St.center),
            "terms": [list(t) for t in St.terms],
            "coeffs": [float(c) for c in St.coeffs],
            "dtype": np.dtype(St.dtype).name}


def _dia_spec(A):
    return ({"kind": "dia", "ndiags": len(A.diags),
             "offsets": [int(o) for o in A.offsets],
             "shape": [int(s) for s in A.shape]},
            {f"diag{i}": np.asarray(d) for i, d in enumerate(A.diags)})


def _ell_spec(E):
    arrays = {"data": np.asarray(E.data), "cols": np.asarray(E.cols)}
    if E.adj is not None:
        arrays.update(adj_data=np.asarray(E.adj.data),
                      adj_cols=np.asarray(E.adj.cols))
    return {"kind": "ell", "shape": [int(s) for s in E.shape]}, arrays


def _random_ell(m, n, seed, with_adjoint=False, **kw):
    """test_parallel.py's ``_random_ell`` (density 0.05)."""
    ell = jfix.random_sparse(m, n, 0.05, seed=seed, **kw).to_ell()
    return ell.with_adjoint() if with_adjoint else ell


def _dense(n, seed):
    rng = np.random.default_rng(seed)
    return np.eye(n) * 4.0 + 0.5 * rng.standard_normal((n, n)) / np.sqrt(n)


OPS = {  # name: () -> JAX operator (whole)
    "laplacian(8,3)/f64": lambda: jits.laplacian(8, 3, dtype=F64),
    "laplacian(8,3)/f32": lambda: jits.laplacian(8, 3, dtype=F32),
    "advection_stencil(8)/f64":
        lambda: jits.advection_diffusion_stencil(8, dtype=F64),
    "laplacian(16,2)/f64": lambda: jits.laplacian(16, 2, dtype=F64),
    "advection_dia(8)/f64": lambda: jfix.advection_diffusion(8, dtype=F64)[0],
    "laplace_dia(16,2)/f32": lambda: jfix.laplace_dia(16, 2, dtype=F32),
    "laplace_dia(16,2)/f64": lambda: jfix.laplace_dia(16, 2, dtype=F64),
    "laplace_dia(16,3)/f32": lambda: jfix.laplace_dia(16, 3, dtype=F32),
    "ell(512,128)+adj": lambda: _random_ell(512, 128, 14, True),
    "ell(512,128)": lambda: _random_ell(512, 128, 14),
    "ell(256,256)": lambda: _random_ell(256, 256, 10),
    "ell(256,128)": lambda: _random_ell(256, 128, 11),
    "ell(256,128)+adj": lambda: _random_ell(256, 128, 12, True),
    "spd_ell(256)": lambda: jfix.random_sparse(
        256, 256, 0.05, seed=15, symmetrize=True, shift=4.0).to_ell(),
    "spd_ell(256)+adj": lambda: jfix.random_sparse(
        256, 256, 0.05, seed=2, dtype=F64, symmetrize=True,
        shift=1.0).to_ell().with_adjoint(),
    "dense(37)": lambda: jnp.asarray(
        np.random.default_rng(9).standard_normal((37, 37))),
    "dense(1003)/f64": lambda: jnp.asarray(_dense(1003, 7)),
    "dense(1003)/f32": lambda: jnp.asarray(_dense(1003, 7).astype(F32)),
}


def _spec(name, shard=False):
    """The port spec and arrays of ``OPS[name]``."""
    A = OPS[name]()
    if isinstance(A, jits.StencilOperator):
        spec, arrays = _stencil_spec(A), {}
    elif isinstance(A, jits.DIAMatrix):
        spec, arrays = _dia_spec(A)
    elif type(A).__name__ == "ELLMatrix":
        spec, arrays = _ell_spec(A)
    else:
        spec, arrays = {"kind": "dense"}, {"mat": np.asarray(A)}
    if shard:
        spec["shard"] = True
    return spec, arrays


def _jax_op(name, mesh):
    A = OPS[name]()
    if isinstance(A, jits.StencilOperator):
        return jsh.HaloStencilOperator(A, mesh)
    if isinstance(A, jits.DIAMatrix):
        return jsh.HaloDIAOperator(A, mesh)
    if type(A).__name__ == "ELLMatrix":
        return jsh.RowShardedELLOperator(A, mesh)
    return jsh.DenseMeshOperator(A, mesh)


def _rng_x(n, dtype, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _panel(n, k, dtype, seed):
    return np.random.default_rng(seed).random((k, n)).astype(dtype)


# ---- the launches -----------------------------------------------------------

ROWS = ("laplacian(8,3)/f64", "laplacian(8,3)/f32",
        "advection_stencil(8)/f64", "advection_dia(8)/f64",
        "laplace_dia(16,2)/f32")

SOLVES = {  # name: (solver, operator, inputs (n,) -> arrays, keywords)
    "block_cg": ("block_cg", "laplace_dia(16,2)/f64",
                 lambda n: {"b": np.random.default_rng(6)
                            .standard_normal((n, 4))},
                 dict(reltol=1e-10, maxiter=600)),
    "block_cg_f32": ("block_cg", "laplacian(8,3)/f32",
                     lambda n: {"b": np.random.default_rng(3)
                                .standard_normal((n, 3)).astype(F32)},
                     dict(reltol=1e-5, maxiter=600)),
    "lobpcg": ("lobpcg", "laplacian(16,2)/f64",
               lambda n: {"X0": np.random.default_rng(4)
                          .standard_normal((n, 3))},
               dict(largest=False, tol=1e-6, maxiter=400)),
    "lsqr": ("lsqr", "ell(512,128)+adj", None,
             dict(atol=1e-10, btol=1e-10, maxiter=300)),
    "lsqr_scatter": ("lsqr", "ell(512,128)", None,
                     dict(atol=1e-10, btol=1e-10, maxiter=300)),
    "lsmr": ("lsmr", "ell(512,128)+adj", None,
             dict(atol=1e-10, btol=1e-10, maxiter=300)),
    "lsmr_stencil": ("lsmr", "advection_stencil(8)/f64",
                     lambda n: {"b": np.ones(n)},
                     dict(atol=1e-10, btol=1e-10, maxiter=300)),
    "svdl_stencil": ("svdl", "advection_stencil(8)/f64",
                     lambda n: {"v0": _rng_x(n, F64, 11)},
                     dict(nsv=3, tol=1e-10)),
    "svdl_ell": ("svdl", "ell(512,128)+adj",
                 lambda n: {"v0": _rng_x(128, F64, 12)},
                 dict(nsv=3, tol=1e-10)),
    "cg_shard_dia": ("cg", "laplace_dia(16,2)/f64",
                     lambda n: {"b": np.ones(n)},
                     dict(reltol=1e-10, maxiter=500)),
    "cg_shard_ell": ("cg", "spd_ell(256)", lambda n: {"b": np.ones(n)},
                     dict(reltol=1e-10, maxiter=500)),
    "gmres_dense_f64": ("gmres", "dense(1003)/f64",
                        lambda n: {"b": np.ones(n)},
                        dict(reltol=1e-10, restart=20, maxiter=200)),
    "gmres_dense_f32": ("gmres", "dense(1003)/f32",
                        lambda n: {"b": np.ones(n, F32)},
                        dict(reltol=1e-5, restart=20, maxiter=200)),
}
SHARDED = ("cg_shard_dia", "cg_shard_ell")


def _lsq_rhs(name):
    """b = A x_true of test_parallel.py's LSQR case."""
    E = OPS[name]()
    x_true = np.random.default_rng(6).random(E.shape[1])
    return np.asarray(E.to_dense()) @ x_true


def _solve_inputs(name):
    solver, opname, make, kw = SOLVES[name]
    A = OPS[opname]()
    if make is None:
        return {"b": _lsq_rhs(opname)}
    return make(A.shape[0])


def _cases(D):
    out = []
    for name in ROWS:
        spec, arrays = _spec(name)
        A = OPS[name]()
        dt = F32 if name.endswith("f32") else F64
        out.append(({"name": f"rows/{name}", "kind": "rows", "op": spec},
                    {**arrays, "X": _panel(A.shape[0], 3, dt, 5)}))
    if D != 4:
        return out
    for name, (solver, opname, _, kw) in SOLVES.items():
        spec, arrays = _spec(opname, shard=name in SHARDED)
        if solver == "gmres":
            case = {"name": f"solve/{name}", "kind": "gmres", "op": spec,
                    "kw": kw}
        else:
            case = {"name": f"solve/{name}", "kind": "solve", "op": spec,
                    "solver": solver, "kw": kw}
        out.append((case, {**arrays, **_solve_inputs(name)}))
    # the unsharded counterparts of shard_dia / shard_ell
    for name in SHARDED:
        solver, opname, make, kw = SOLVES[name]
        spec, arrays = _spec(opname)
        out.append(({"name": f"solve/{name}/halo", "kind": "solve",
                     "op": spec, "solver": solver, "kw": kw},
                    {**arrays, **make(OPS[opname]().shape[0])}))
    for name in ("ell(256,256)", "ell(256,128)", "ell(256,128)+adj",
                 "dense(37)"):
        spec, arrays = _spec(name)
        m, n = OPS[name]().shape
        out.append(({"name": f"ops/{name}", "kind": "mesh_ops", "op": spec},
                    {**arrays, "x": _rng_x(n, F64, 3),
                     "y": _rng_x(m, F64, 4)}))
    spec, arrays = _spec("laplace_dia(16,3)/f32")
    out.append(({"name": "step/halo", "kind": "cg_step", "op": spec},
                {**arrays, "b": np.ones(4096, F32)}))
    return out


def _slice_cases():
    """test_parallel.py's slice-mesh cases on slice_mesh(2, 2)."""
    spec, arrays = _spec("laplace_dia(16,2)/f64")
    x = np.random.default_rng(0).standard_normal(256)
    espec, earr = _spec("spd_ell(256)+adj")
    return [({"name": "halo", "kind": "halo_ops", "op": spec},
             {**arrays, "x": x}),
            ({"name": "cg", "kind": "solve", "op": spec, "solver": "cg",
              "kw": dict(reltol=1e-10, maxiter=400)},
             {**arrays, "b": np.ones(256)}),
            ({"name": "ell", "kind": "mesh_ops", "op": espec},
             {**earr, "x": np.random.default_rng(1).standard_normal(256),
              "y": np.random.default_rng(1).standard_normal(256)})]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """``port(D)``: every rank's outputs of the D-rank launch (run once);
    ``port("slice")`` the four ranks of slice_mesh(2, 2)."""
    done = {}

    def get(D):
        if D not in done:
            tmp = tmp_path_factory.mktemp(f"ranks{D}")
            if D == "slice":
                done[D] = launch(_slice_cases(), 4, tmp,
                                 timeout=PROCESS_TIMEOUT, mesh="slice:2x2")
            else:
                done[D] = launch(_cases(D), D, tmp, timeout=PROCESS_TIMEOUT)
        return done[D]

    return get


def _out(ranks, case):
    pre = case + "/"
    return {k[len(pre):]: v for k, v in ranks[0].items() if k.startswith(pre)}


def _mesh(D):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jsh.row_mesh(D)


def _close(got, want, dtype):
    want = np.asarray(want)
    if dtype == F64:
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-13 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


# ---- mv_rows -------------------------------------------------------------------

@pytest.mark.parametrize("D", [4, 1])
@pytest.mark.parametrize("name", ROWS)
def test_halo_mv_rows_matches_jax(port, name, D):
    """mv_rows of a (3, n) panel sharded over its columns, against the JAX
    package's ``mv_rows`` on row_mesh(D) (test_parallel.py:288,
    test_parallel_stencil.py:256), with one exchange a panel on D > 1."""
    got = _out(port(D), f"rows/{name}")
    dt = F32 if name.endswith("f32") else F64
    op = _jax_op(name, _mesh(D))
    X = _panel(op.shape[0], 3, dt, 5)
    Xr = jax.device_put(jnp.asarray(X), NamedSharding(_mesh(D),
                                                      P(None, "rows")))
    want = jax.jit(lambda o, v: o.mv_rows(v))(op, Xr)
    _close(got["Y"], want, dt)
    assert int(got["permutes"]) == (2 if D > 1 else 0)


# ---- RowShardedELLOperator and DenseMeshOperator ---------------------------------

@pytest.mark.parametrize("name", ["ell(256,256)", "ell(256,128)",
                                  "ell(256,128)+adj", "dense(37)"])
def test_mesh_operator_products_match_jax(port, name):
    """mv and rmv of the ELL operator (square; rectangular with the
    reduce-scatter adjoint and with a precomputed one,
    test_parallel.py:142-181) and of the dense operator at n = 37, D = 4
    (the last block short, test_parallel.py:531-545) against the JAX
    operator on row_mesh(4) and the dense product.  The ELL ``mv``
    all-gathers x once and permutes nothing; the adjoint-free ``rmv``
    reduce-scatters once and all-reduces nothing."""
    got = _out(port(4), f"ops/{name}")
    mesh = _mesh(4)
    A = OPS[name]()
    op = _jax_op(name, mesh)
    m, n = A.shape
    x, y = _rng_x(n, F64, 3), _rng_x(m, F64, 4)
    dense = np.asarray(A.to_dense() if hasattr(A, "to_dense") else A)
    if name.startswith("ell"):
        xs, ys = jsh.shard_vector(jnp.asarray(x), mesh), jsh.shard_vector(
            jnp.asarray(y), mesh)
    else:
        xs, ys = jnp.asarray(x), jnp.asarray(y)
    mv, rmv = jax.jit(lambda o, a, b: (o.mv(a), o.rmv(b)))(op, xs, ys)
    _close(got["mv"], mv, F64)
    _close(got["rmv"], rmv, F64)
    _close(got["mv"], dense @ x, F64)
    _close(got["rmv"], dense.T @ y, F64)
    if name.startswith("ell"):
        assert int(got["mv/all-gather"]) == 1
        assert int(got["mv/collective-permute"]) == 0
        if name.endswith("+adj"):
            assert int(got["rmv/all-gather"]) == 1
        else:
            assert int(got["rmv/reduce-scatter"]) == 1
            assert int(got["rmv/all-reduce"]) == 0


def test_mesh_operator_guards():
    """n % D != 0 raises for the ELL operator (test_parallel.py:240) and
    for shard_dia / shard_ell, as the JAX package's device_put of an uneven
    NamedSharding does; the dense operator takes any n but wants a square
    matrix."""
    mesh = types.SimpleNamespace(size=4, rank=0, device=torch.device("cpu"))
    spec, arrays = _ell_spec(_random_ell(250, 250, 16))
    E = convert.operator_from_arrays({**spec, **arrays}, device="cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        ppar.RowShardedELLOperator(E, mesh)
    with pytest.raises(ValueError, match="divide evenly"):
        ppar.shard_ell(E, mesh)
    with pytest.raises(ValueError, match="divide evenly"):
        ppar.shard_dia(port_dia(jfix.laplace_dia(7, 2)), mesh)
    with pytest.raises(ValueError):
        jsh.shard_dia(jfix.laplace_dia(7, 2), _mesh(4))
    with pytest.raises(ValueError, match="square"):
        ppar.DenseMeshOperator(torch.ones(4, 3), mesh)


# ---- the solvers on a mesh -----------------------------------------------------

def test_block_cg_on_halo_dia_matches_jax(port):
    """Block CG with 4 right-hand sides on the halo DIA operator, D = 4,
    against the JAX package on row_mesh(4) (test_parallel.py:517-528):
    equal steps, X and the per-column residual series within 1e-10."""
    got = _out(port(4), "solve/block_cg")
    mesh = _mesh(4)
    op = _jax_op("laplace_dia(16,2)/f64", mesh)
    B = jnp.asarray(_solve_inputs("block_cg")["b"])
    X, h = jits.block_cg(op, B, reltol=1e-10, maxiter=600, log=True)
    assert h.isconverged and bool(got["converged"])
    assert int(got["iters"]) == h.iters
    assert rel(got["x"], np.asarray(X)) <= 1e-10
    np.testing.assert_allclose(got["resnorm"], h["resnorm"], rtol=1e-10,
                               atol=1e-12 * np.abs(h["resnorm"]).max())


def test_block_cg_f32_on_halo_stencil_matches_jax(port):
    """f32 block CG on the halo stencil (the stencil kernel's rows' plain
    version here): within 2 steps and 1e-4 of the JAX package's mesh run."""
    got = _out(port(4), "solve/block_cg_f32")
    op = _jax_op("laplacian(8,3)/f32", _mesh(4))
    B = jnp.asarray(_solve_inputs("block_cg_f32")["b"])
    X, h = jits.block_cg(op, B, reltol=1e-5, maxiter=600, log=True)
    assert h.isconverged and bool(got["converged"])
    assert abs(int(got["iters"]) - h.iters) <= 2
    assert rel(got["x"], np.asarray(X)) <= 1e-4


def test_lobpcg_on_halo_stencil_matches_jax(port):
    """LOBPCG, 3 smallest, on the halo stencil, D = 4, against the JAX
    package on row_mesh(4) (test_parallel_stencil.py:273-289): equal
    iterations, eigenvalues within 1e-10, the same invariant subspace, and
    the analytic eigenvalues."""
    got = _out(port(4), "solve/lobpcg")
    mesh = _mesh(4)
    op = _jax_op("laplacian(16,2)/f64", mesh)
    X0 = jax.device_put(jnp.asarray(_solve_inputs("lobpcg")["X0"]),
                        NamedSharding(mesh, P("rows", None)))
    r = jits.lobpcg(op, X0, largest=False, tol=1e-6, maxiter=400)
    assert r.converged and bool(got["converged"])
    assert int(got["iters"]) == r.iterations
    assert rel(got["lam"], np.asarray(r.lam)) <= 1e-10
    Xp, Xj = got["X"], np.asarray(r.X)
    s = np.linalg.svd(Xp.T @ Xj, compute_uv=False)
    assert np.abs(s - 1).max() <= 1e-8
    k = np.arange(1, 17)
    lam1 = 2 - 2 * np.cos(np.pi * k / 17)
    exact = np.sort((lam1[:, None] + lam1[None, :]).ravel())[:3]
    assert np.abs(got["lam"] - exact).max() <= 1e-8
    assert (got["resnorms"] <= 1e-6).all()


def _rel_max(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300),
                        initial=0.0))


def _check_lsq(got, solver, J, b, kw, other=None):
    """The port's mesh solve against the JAX package's solve of b on ``J``
    (a mesh operator takes b sharded), within 1e-10 plus four times the
    JAX package's own spread: its answer for b (1 + 1e-15), and on
    ``other`` (the same matrix on a mesh or on one device), against its
    answer for b (``tests/test_torch_block_lsq.py``).  This sprand system's
    late residual estimates sit at their rounding floor, which that change
    of b alone moves by ~20%, and rounding decides the last step (the JAX
    package's mesh and one-device LSMR differ by one), so the steps are
    held within one, istop equal, and the series on their common steps."""
    def place(J):
        if hasattr(J, "mesh"):
            return lambda v: jsh.shard_vector(v, J.mesh)
        return lambda v: v

    xj, hj = getattr(jits, solver)(J, place(J)(jnp.asarray(b)), log=True,
                                   **kw)
    xm, hm = getattr(jits, solver)(J, place(J)(jnp.asarray(b) * (1 + 1e-15)),
                                   log=True, **kw)
    spread = rel(np.asarray(xm), np.asarray(xj))
    if other is not None:
        xo = getattr(jits, solver)(other, place(other)(jnp.asarray(b)), **kw)
        spread = max(spread, rel(np.asarray(xo), np.asarray(xj)))
    assert int(got["istop"]) == hj["istop"] and hj.isconverged
    assert abs(int(got["iters"]) - hj.iters) <= 1
    for key in ("resnorm", "rnorm", "anorm"):
        if key not in hj.data or not len(got.get(key, [])):
            continue
        want, moved = np.asarray(hj[key]), np.asarray(hm[key])
        k = min(len(want), len(moved), len(got[key]))
        limit = 1e-10 + 4 * _rel_max(moved[:k], want[:k])
        assert _rel_max(got[key][:k], want[:k]) <= limit, (key, limit)
    assert rel(got["x"], np.asarray(xj)) <= 1e-10 + 4 * spread
    return spread


@pytest.mark.parametrize("name", ["lsqr", "lsqr_scatter"])
def test_lsqr_on_row_sharded_ell_matches_jax(port, name):
    """LSQR on the 512 x 128 ELL operator, D = 4, with its precomputed
    adjoint and with the reduce-scatter ``rmv``, against the JAX package on
    row_mesh(4) (test_parallel.py:196-207), held as ``_check_lsq`` says,
    and the least-squares residual."""
    got = _out(port(4), f"solve/{name}")
    solver, opname, _, kw = SOLVES[name]
    b = _lsq_rhs(opname)
    _check_lsq(got, "lsqr", _jax_op(opname, _mesh(4)), b, kw)
    dense = np.asarray(OPS[opname]().to_dense())
    assert np.linalg.norm(dense @ got["x"] - b) / np.linalg.norm(b) < 1e-6


def _one_device(A):
    """The port's one-device operator of the JAX stencil or ELL ``A``."""
    if isinstance(A, jits.StencilOperator):
        return port_stencil(A)
    spec, arrays = _ell_spec(A)
    return convert.operator_from_arrays(
        {**spec, "data": arrays["data"], "cols": arrays["cols"]},
        device="cpu")


@pytest.mark.parametrize("name", ["lsmr", "lsmr_stencil"])
def test_lsmr_on_a_mesh_matches_jax_single_device(port, name):
    """LSMR on the ELL operator and on the nonsymmetric halo stencil, D = 4,
    against the JAX package's single-device LSMR (``_check_lsq``, its mesh
    run in the spread) and the port's own one-device run (steps within
    one, x within 1e-10 plus four times that spread)."""
    got = _out(port(4), f"solve/{name}")
    solver, opname, _, kw = SOLVES[name]
    A = OPS[opname]()
    b = _solve_inputs(name)["b"]
    spread = _check_lsq(got, "lsmr", A, b, kw, other=_jax_op(opname,
                                                             _mesh(4)))
    xp, hp = pits.lsmr(_one_device(A), to_torch(b), log=True, **kw)
    assert abs(hp.iters - int(got["iters"])) <= 1
    assert rel(got["x"], to_numpy(xp)) <= 1e-10 + 4 * spread


# ---- svdl: the JAX package's single-device references in a fresh interpreter

def _jax_svdl_references(out):
    """Script mode: the JAX package's single-device svdl of each svdl case
    (vecs='both', log), written to ``out`` as .npz."""
    res = {}
    for name, (solver, opname, make, kw) in SOLVES.items():
        if solver != "svdl":
            continue
        A = OPS[opname]()
        v0 = jnp.asarray(make(A.shape[0])["v0"])
        (U, s, Vt), _, h = jits.svdl(A, v0=v0, vecs="both", log=True, **kw)
        for key, v in {"s": s, "U": U, "Vt": Vt, "iters": h.iters,
                       "ritz": h["ritz"]}.items():
            res[f"{name}/{key}"] = np.asarray(v)
    np.savez(out, **res)


@pytest.fixture(scope="module")
def jax_svdl(tmp_path_factory):
    out = tmp_path_factory.mktemp("svdl") / "refs.npz"
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, here]))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(out)], capture_output=True, env=env, cwd=root,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    refs = dict(np.load(out))
    return lambda name: {k.split("/", 1)[1]: v for k, v in refs.items()
                         if k.startswith(name + "/")}


def _same_up_to_sign(got, want, tol):
    """Each column (or row) of ``got`` equals ``want``'s up to its sign."""
    sign = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got * sign, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("name", ["svdl_stencil", "svdl_ell"])
def test_svdl_on_a_mesh_matches_jax_single_device(port, jax_svdl, name):
    """svdl, 3 largest, on the nonsymmetric halo stencil (square) and the
    512 x 128 ELL operator (rectangular: left vectors sharded by rows,
    right ones by columns), D = 4, from the same v0: equal macro-
    iterations, singular values and Ritz history within 1e-10 of the JAX
    package's single-device svdl and of the port's one-device run, the
    singular vectors up to sign within 1e-8."""
    got = _out(port(4), f"solve/{name}")
    ref = jax_svdl(name)
    solver, opname, make, kw = SOLVES[name]
    A = OPS[opname]()
    assert int(got["iters"]) == int(ref["iters"])
    assert rel(got["values"], ref["s"]) <= 1e-10
    np.testing.assert_allclose(got["ritz"], ref["ritz"], rtol=1e-10,
                               atol=1e-12 * np.abs(ref["ritz"]).max())
    _same_up_to_sign(got["left"], ref["U"], 1e-8)
    _same_up_to_sign(got["right"].T, ref["Vt"].T, 1e-8)
    s1, _, h1 = pits.svdl(_one_device(A), v0=to_torch(make(A.shape[0])["v0"]),
                          log=True, **kw)
    assert h1.iters == int(got["iters"])
    assert rel(got["values"], to_numpy(s1)) <= 1e-10


def test_ranks_hold_the_same_replicated_state(port):
    """Every rank of the D = 4 launch took the same steps of block CG,
    LOBPCG, LSQR, LSMR and svdl (and of the CG and GMRES runs beside them)
    with the same scalars and histories, and gathered the same vectors:
    each host read decides from allreduced values only."""
    ranks = port(4)
    keys = [k for k in ranks[0] if k.startswith("solve/")]
    solvers = {SOLVES[k.split("/")[1]][0] for k in keys}
    assert {"block_cg", "lobpcg", "lsqr", "lsmr", "svdl"} <= solvers
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


# ---- DenseMeshOperator's GMRES, shard_dia / shard_ell, slice_mesh -------------

@pytest.mark.parametrize("dtype", [F64, F32])
def test_gmres_on_dense_mesh_operator_takes_the_padded_panel_route(port,
                                                                   dtype):
    """GMRES(20) on the dense operator at n = 1003, D = 4: the sharded-panel
    route with the zero-padded last shard (test_parallel.py:424-445), one
    distributed CGS2 a step; f64 (gemv sweeps) against the JAX package on
    row_mesh(4) and on one device within 1e-8, f32 through the two CGS2
    sweeps (their plain versions here), each twice a step, within 1e-4."""
    name = f"gmres_dense_{'f64' if dtype == F64 else 'f32'}"
    got = _out(port(4), f"solve/{name}")
    mesh = _mesh(4)
    solver, opname, make, kw = SOLVES[name]
    A = OPS[opname]()
    b = jnp.asarray(make(1003)["b"])
    xm = jits.gmres(jsh.DenseMeshOperator(A, mesh), b, **kw)
    x1 = jits.gmres(A, b, **kw)
    assert bool(got["converged"])
    steps = int(got["calls/dist_panel_ortho"])
    assert steps == kw["restart"] * (int(got["restarts"]) + 1)
    tol = 1e-8 if dtype == F64 else 1e-4
    assert rel(got["x"], np.asarray(xm)) <= tol
    assert rel(got["x"], np.asarray(x1)) <= tol
    if dtype == F32:
        assert int(got["calls/panel_dots"]) == 2 * steps
        assert int(got["calls/panel_update"]) == 2 * steps
    else:
        assert int(got["calls/panel_dots"]) == 0
    r = np.asarray(A, np.float64) @ got["x"] - 1.0
    assert np.linalg.norm(r) / np.sqrt(1003) < (1e-9 if dtype == F64
                                                else 1e-4)


@pytest.mark.parametrize("name", SHARDED)
def test_shard_dia_and_shard_ell_cg_match_jax(port, name):
    """CG through shard_dia (laplace_dia(16,2), test_parallel.py:72) and
    shard_ell (the SPD sprand, :210), D = 4: the same steps and x as the
    halo / ELL operator they return, and as the JAX package's GSPMD CG on
    row_mesh(4) within 1e-10."""
    got = _out(port(4), f"solve/{name}")
    halo = _out(port(4), f"solve/{name}/halo")
    mesh = _mesh(4)
    solver, opname, make, kw = SOLVES[name]
    A = OPS[opname]()
    As = (jsh.shard_dia(A, mesh) if name.endswith("dia")
          else jsh.shard_ell(A, mesh))
    x, h = jits.cg(As, jsh.shard_vector(jnp.ones(A.shape[0]), mesh),
                   log=True, **kw)
    assert h.isconverged and bool(got["converged"])
    assert int(got["iters"]) == int(halo["iters"]) == h.iters
    np.testing.assert_array_equal(got["x"], halo["x"])
    assert rel(got["x"], np.asarray(x)) <= 1e-10


def test_slice_mesh_matches_jax(port):
    """slice_mesh(2, 2) on four ranks (test_parallel.py:244-285): the halo
    SpMV, CG and the ELL product and adjoint against the JAX package's
    slice_mesh(2, 2); CG's all-reduces ran at both levels, one of each per
    reduction, and every rank holds the same state."""
    ranks = port("slice")
    m2 = jsh.slice_mesh(2, 2)
    A = OPS["laplace_dia(16,2)/f64"]()
    x = np.random.default_rng(0).standard_normal(256)
    got = _out(ranks, "halo")
    _close(got["mv"], np.asarray(A.mv(jnp.asarray(x))), F64)
    _close(got["rmv"], np.asarray(A.rmv(jnp.asarray(x))), F64)
    cg = _out(ranks, "cg")
    xj, h = jits.cg(jsh.HaloDIAOperator(A, m2),
                    jsh.shard_vector(jnp.ones(256), m2), reltol=1e-10,
                    maxiter=400, log=True)
    assert bool(cg["converged"]) and int(cg["iters"]) == h.iters
    assert rel(cg["x"], np.asarray(xj)) <= 1e-10
    chip, sl = int(cg["allreduce/chip"]), int(cg["allreduce/slice"])
    assert chip == sl >= 2 * h.iters
    C = OPS["spd_ell(256)+adj"]()
    E = jsh.RowShardedELLOperator(C, m2)
    v = np.random.default_rng(1).standard_normal(256)
    vs = jsh.shard_vector(jnp.asarray(v), m2)
    e = _out(ranks, "ell")
    _close(e["mv"], np.asarray(E.mv(vs)), F64)
    _close(e["rmv"], np.asarray(E.rmv(vs)), F64)
    for r in ranks[1:]:
        for k in ranks[0]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def test_parallel_exports_every_jax_name():
    """``iterativesolvers_tpu_torch.parallel`` exports every name of the JAX
    package's ``parallel/__init__.py``, and ``DenseMeshOperator``."""
    import iterativesolvers_tpu.parallel as jpar

    assert set(jpar.__all__) <= set(ppar.__all__)
    for name in (*jpar.__all__, "DenseMeshOperator"):
        assert getattr(ppar, name) is not None, name


# ---- the collectives of a step, and utils/profiling ---------------------------

def test_collective_counts_of_a_halo_cg_step(port):
    """test_hlo_collectives.py's audit of a CG step on the halo DIA
    operator: two collective-permutes (one exchange), at least two
    all-reduces, no all-gather or all-to-all."""
    c = _out(port(4), "step/halo")
    assert int(c["collective-permute"]) == 2
    assert int(c["all-reduce"]) >= 2
    assert int(c["all-gather"]) == 0 and int(c["all-to-all"]) == 0


def test_roofline_report_and_trace_match_jax(tmp_path):
    """roofline_report's arithmetic against the JAX function's on the same
    numbers; trace writes its Chrome trace; measure_bandwidth on the CPU
    gives a positive rate; collective_counts of a one-rank mesh is all
    zeros."""
    from iterativesolvers_tpu.utils import profiling as jprof

    for args in ((80_000_000, 2.5e-4, 3.35e12), (123, 1e-6, 1e9)):
        want, got = jprof.roofline_report(*args), profiling.roofline_report(
            *args)
        assert got.roofline_iter_s == want.roofline_iter_s
        assert got.fraction == want.fraction and repr(got) == repr(want)
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(1000).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert profiling.measure_bandwidth(1 << 12, reps=1, device="cpu") > 0
    mesh = ppar.RowMesh(0, 1, "cpu", "gloo")
    with profiling.collective_counts(mesh) as c:
        mesh.all_reduce(torch.ones(2))
        mesh.exchange(torch.ones(1), torch.ones(1))
    assert c == dict.fromkeys(jprof.collective_counts(""), 0)


if __name__ == "__main__":
    _jax_svdl_references(sys.argv[1])
