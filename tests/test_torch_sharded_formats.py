"""The row-sharded stored matrices of ``shard_dia`` / ``shard_ell`` against
the JAX package's on its 8-virtual-device CPU mesh.

The JAX package's ``shard_dia`` / ``shard_ell`` return a ``DIAMatrix`` /
``ELLMatrix`` whose arrays are row-sharded under GSPMD, and every route of
a stored matrix runs on them.  The port's return ``RowShardedDIAMatrix`` /
``RowShardedELLOperator``; here each route runs on them in one launch of
four gloo ranks of ``tests/_torch_dist.py`` (case kind ``sharded``), and
the JAX package's answers come from ``row_mesh(4)`` on the same numpy
inputs, computed in this process while the ranks run.

Matrices: ``laplace_dia(2, 3)`` (n = 8: its halo of 4 spans two blocks of
2), a symmetric diagonally dominant DIA with offsets (-48, 0, 48) at n = 64
(the widest offset reaches the farthest rank), the two-field coupled DIA
at 2 x 4^3 (each field ``laplace_dia(4, 3)`` shifted by 0.6, coupling
diagonals at +-4^3 of 0.5: two blocks away), the rectangular (64, 32) DIA
with offsets (-8, 0, 4, 40) and its ELL form with and without its adjoint,
and ``laplace_dia(4, 3)`` and its ELL form.

Tolerances: products in f64 at rtol 1e-12, in f32 within 1e-6 max|y|;
``diagonal``, ``to_csr``, ``to_dense``, ``astype``, ``compress_values`` and
``gershgorin_bounds`` bit for bit; CG, MINRES, LOBPCG, LSQR and the
preconditioned solves in f64 within 1e-10 with equal steps (LSQR's
residual series within 1e-10 plus four times the JAX package's own spread
under b (1 + 1e-15), as its estimates reach their rounding floor); the
stationary methods' 5 sweeps at 1e-12; ``power_bound`` on the sharded DIA
and on a ``HaloDIAOperator`` within 1e-12 of one device's from the same
generator.
"""

import ast
import inspect
import pathlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import iterativesolvers_tpu as jits
from iterativesolvers_tpu.parallel import sharded as jsh
from iterativesolvers_tpu.parallel.precond import (
    ShardedBlockJacobiPreconditioner as JaxBlockJacobi)
from iterativesolvers_tpu.utils import fixtures as jfix

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.operators.sparse import DIAMatrix, ELLMatrix
from iterativesolvers_tpu_torch.parallel import sharded as psh

import graft_entry_torch
from _torch_dist import start
from _torch_port import port_dia, rel, to_numpy

D = 4
PROCESS_TIMEOUT = 150
F64, F32 = np.float64, np.float32


# ---- the matrices, as numpy diagonals ---------------------------------------

def _lap(side, dims):
    A = jfix.laplace_dia(side, dims)
    return [np.asarray(d) for d in A.diags], tuple(A.offsets), A.shape


def _wide():
    """Symmetric, diagonally dominant, offsets (-48, 0, 48) at n = 64."""
    n, rng = 64, np.random.default_rng(21)
    v = rng.uniform(-1.0, 1.0, 16)
    up, dn = np.zeros(n), np.zeros(n)
    up[:16], dn[48:] = v, v          # A[i, i + 48] = A[i + 48, i]
    return [dn, 3.0 + rng.uniform(0.0, 1.0, n), up], (-48, 0, 48), (n, n)


def _coupled(side):
    """Two fields of laplace_dia(side, 3) + 0.6 I, coupled by 0.5 at
    +-side^3 (field-major)."""
    diags, offs, (n, _) = _lap(side, 3)
    field = [np.concatenate([d, d]) + (0.6 if o == 0 else 0.0)
             for d, o in zip(diags, offs)]
    dn, up = np.zeros(2 * n), np.zeros(2 * n)
    dn[n:], up[:n] = 0.5, 0.5
    return [dn, *field, up], (-n, *offs, n), (2 * n, 2 * n)


def _rect():
    """(64, 32), offsets (-8, 0, 4, 40): the last falls wholly outside."""
    n, m, rng = 64, 32, np.random.default_rng(22)
    offs, diags = (-8, 0, 4, 40), []
    for o in offs:
        d = rng.standard_normal(n)
        c = np.arange(n) + o
        d[(c < 0) | (c >= m)] = 0.0
        diags.append(d)
    return diags, offs, (n, m)


DIAS = {"lap(2,3)": lambda: _lap(2, 3), "lap(4,3)": lambda: _lap(4, 3),
        "wide(64)": _wide, "coupled(4)": lambda: _coupled(4),
        "rect(64,32)": _rect}


def _jax_dia(name, dtype=F64):
    diags, offs, shape = DIAS[name]()
    return jits.DIAMatrix([d.astype(dtype) for d in diags], offs, shape)


def _jax_matrix(name, dtype=F64):
    """The whole JAX matrix of a case's matrix name: a DIA name, or
    ``ell:<DIA name>`` (with ``+adj``) for its ELL form."""
    if name.startswith("ell:"):
        base = name[4:].removesuffix("+adj")
        E = _jax_dia(base, dtype).to_csr().to_ell()
        return E.with_adjoint() if name.endswith("+adj") else E
    return _jax_dia(name, dtype)


def _spec(name, dtype=F64):
    """The port spec (``"shard": true``) and arrays of the case matrix."""
    A = _jax_matrix(name, dtype)
    if name.startswith("ell:"):
        arrays = {"data": np.asarray(A.data), "cols": np.asarray(A.cols)}
        if A.adj is not None:
            arrays.update(adj_data=np.asarray(A.adj.data),
                          adj_cols=np.asarray(A.adj.cols))
        return {"kind": "ell", "shape": list(A.shape), "shard": True}, arrays
    return ({"kind": "dia", "ndiags": len(A.diags),
             "offsets": list(A.offsets), "shape": list(A.shape),
             "shard": True},
            {f"diag{i}": np.asarray(d) for i, d in enumerate(A.diags)})


POWER_SEED = 3
SOLVE_KW = {"cg": dict(reltol=1e-10, maxiter=400),
            "minres": dict(reltol=1e-10, maxiter=400),
            "lobpcg": dict(largest=False, tol=1e-8, maxiter=200),
            "cg:ic": dict(reltol=1e-10, maxiter=400, Pl="ic:natural"),
            "cg:ic_mc": dict(reltol=1e-10, maxiter=400, Pl="ic:multicolor"),
            "gmres:ilu": dict(reltol=1e-10, restart=20, maxiter=400,
                              Pl="ilu:natural"),
            "gmres:ilu_mc": dict(reltol=1e-10, restart=20, maxiter=400,
                                 Pl="ilu:multicolor"),
            "lsqr": dict(atol=1e-12, btol=1e-12, maxiter=400)}

# name: (matrix, dtype, routes, solves, extra case keys)
CASES = {
    "lap23": ("lap(2,3)", F64, ("products", "whole", "bounds", "power",
                                "solves"), ("cg", "minres"), {}),
    "lap23/f32": ("lap(2,3)", F32, ("products",), (), {}),
    "lap43": ("lap(4,3)", F64, ("bounds", "power", "reduced"), (),
              {"halo_power": True, "grid": [4, 3]}),
    "wide": ("wide(64)", F64, ("products", "whole", "bounds", "power",
                               "solves"), ("cg", "minres"), {}),
    "wide/f32": ("wide(64)", F32, ("products",), (), {}),
    "coupled": ("coupled(4)", F64, ("products", "whole", "bounds", "solves",
                                    "stationary"),
                ("cg", "minres", "lobpcg", "cg:ic", "cg:ic_mc",
                 "gmres:ilu_mc"), {}),
    "coupled/f32": ("coupled(4)", F32, ("products",), (), {}),
    "rect": ("rect(64,32)", F64, ("products", "whole", "bounds", "solves"),
             ("lsqr",), {}),
    "rect/f32": ("rect(64,32)", F32, ("products",), (), {}),
    "ell_rect": ("ell:rect(64,32)", F64, ("products", "whole", "bounds",
                                          "solves", "adjoint"),
                 ("lsqr",), {}),
    "ell_rect+adj": ("ell:rect(64,32)+adj", F64, ("products", "whole",
                                                  "solves"), ("lsqr",), {}),
    "ell_lap43": ("ell:lap(4,3)", F64, ("products", "whole", "bounds",
                                        "stationary", "solves"),
                  ("gmres:ilu",), {}),
}


def _inputs(name):
    """x (columns), y (rows), X (3, m), b (rows), X0 (n, 2) from seeds."""
    matrix, dt, *_ = CASES[name]
    n, m = _jax_matrix(matrix).shape
    rng = np.random.default_rng(7)
    return {"x": rng.standard_normal(m).astype(dt),
            "y": rng.standard_normal(n).astype(dt),
            "X": rng.standard_normal((3, m)).astype(dt),
            "b": rng.standard_normal(n).astype(dt),
            "X0": rng.standard_normal((n, 2)).astype(dt)}


def _rank_cases():
    out = []
    for name, (matrix, dt, routes, solves, extra) in CASES.items():
        spec, arrays = _spec(matrix, dt)
        case = {"name": name, "kind": "sharded", "op": spec,
                "do": list(routes),
                "solves": {s: SOLVE_KW[s] for s in solves}, **extra}
        out.append((case, {**arrays, **_inputs(name)}))
    return out


# ---- the JAX package's answers on row_mesh(4) ---------------------------------

def _mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jsh.row_mesh(D)


def _sharded(A, mesh):
    if type(A).__name__ == "ELLMatrix":
        return jsh.shard_ell(A, mesh)
    return jsh.shard_dia(A, mesh)


@jax.jit
def _jax_products(A, x, y, X):
    mv = A.mv(x)
    out = {"mv": mv, "rmv": A.rmv(y), "mv_rows": A.mv_rows(X)}
    if A.shape[0] == A.shape[1]:
        out["mv_dot"] = jnp.vdot(x, mv)
    return out


def _jax_solves(As, mesh, inp, solves):
    out = {}
    b = jsh.shard_vector(jnp.asarray(inp["b"]), mesh)
    for name in solves:
        kw = dict(SOLVE_KW[name])
        if name == "lobpcg":
            X0 = jax.device_put(jnp.asarray(inp["X0"]),
                                NamedSharding(mesh, P("rows", None)))
            r = jits.lobpcg(As, X0, **kw)
            out[name] = {"lam": np.asarray(r.lam), "X": np.asarray(r.X),
                         "iters": r.iterations}
            continue
        pl = kw.pop("Pl", None)
        if pl is not None:
            cls = {"ic": jits.ICPreconditioner,
                   "ilu": jits.ILUPreconditioner}[pl.split(":")[0]]
            kw["Pl"] = cls.from_operator(As, ordering=pl.split(":")[1])
        solver = getattr(jits, name.split(":")[0])
        x, h = solver(As, b, log=True, **kw)
        out[name] = {"x": np.asarray(x), "iters": h.iters,
                     "resnorm": np.asarray(h["resnorm"]), "spread": 0.0}
        if name == "lsqr":
            # LSQR's residual estimates on an inconsistent system sit at
            # their rounding floor: the JAX package's own series under
            # b (1 + 1e-15) (tests/test_torch_parallel_rows.py _check_lsq)
            _, hm = solver(As, b * (1 + 1e-15), log=True, **kw)
            want, moved = out[name]["resnorm"], np.asarray(hm["resnorm"])
            k = min(len(want), len(moved))
            out[name]["spread"] = float(np.max(
                np.abs(moved[:k] - want[:k]) / np.abs(want[:k])))
    return out


def _jax_stationary(As, mesh, inp):
    b = jsh.shard_vector(jnp.asarray(inp["b"]), mesh)
    out = {name: np.asarray(getattr(jits, name)(As, b, maxiter=5))
           for name in ("jacobi", "gauss_seidel")}
    for name in ("sor", "ssor"):
        out[name] = np.asarray(getattr(jits, name)(As, b, 1.2, maxiter=5))
    out["gauss_seidel:multicolor"] = np.asarray(jits.gauss_seidel(
        As, b, maxiter=5, ordering="multicolor"))
    it = jits.sor_iterable(As, b, 1.2, maxiter=5)
    for _ in it:
        pass
    out["sor_iterable"] = np.asarray(it.x)
    return out


def _values(M):
    """The stored values (DIA (ndiag, n), ELL (n, w)) as f64."""
    return np.asarray(M.data).astype(np.float64)


def _jax_whole(As):
    csr = As.to_csr()
    out = {"csr_data": np.asarray(csr.data),
           "csr_indices": np.asarray(csr.indices),
           "csr_indptr": np.asarray(csr.indptr),
           "dense": np.asarray(As.to_dense()),
           "astype": _values(As.astype(F32))}
    if hasattr(As, "offsets"):
        d, present = As.diagonal()
        out.update(diagonal=np.asarray(d), present=np.asarray(present),
                   data=np.asarray(As.data))
    else:
        out["row_width"] = As.row_width
    for dt, key in ((jnp.bfloat16, "bfloat16"), (jnp.int8, "int8")):
        C = jits.compress_values(As, dt)
        out[f"compress/{key}/dtype"] = str(np.dtype(C.dtype))
        out[f"compress/{key}/values"] = _values(C)
        out[f"representable/{key}"] = bool(jits.values_representable(As,
                                                                      dt))
    return out


def _jax_reduced(As, mesh, inp, side, dims):
    R = jits.RBReducedSystem.from_dia(As, side, dims)
    x = jsh.shard_vector(jnp.asarray(inp["x"]), mesh)
    out = {"s_red": np.asarray(R.s_red), "s_black": np.asarray(R.s_black),
           "sr_offsets": np.asarray(R.sr_offsets),
           "sb_offsets": np.asarray(R.sb_offsets),
           "bjacobi": np.asarray(JaxBlockJacobi.ic(As, mesh).ldiv(x)),
           "rbic": np.asarray(jits.RedBlackICPreconditioner.from_dia(
               As, side, dims).ldiv(x))}
    out.update({f"sr{i}": np.asarray(t) for i, t in enumerate(R.sr_streams)})
    out.update({f"sb{i}": np.asarray(t) for i, t in enumerate(R.sb_streams)})
    return out


def _jax_refs():
    mesh, refs = _mesh(), {}
    for name, (matrix, dt, routes, solves, extra) in CASES.items():
        A = _jax_matrix(matrix, dt)
        As = _sharded(A, mesh)
        inp = _inputs(name)
        ref = {}
        if "products" in routes:
            X = jax.device_put(jnp.asarray(inp["X"]),
                               NamedSharding(mesh, P(None, "rows")))
            ref["products"] = {k: np.asarray(v) for k, v in _jax_products(
                As, jsh.shard_vector(jnp.asarray(inp["x"]), mesh),
                jsh.shard_vector(jnp.asarray(inp["y"]), mesh), X).items()}
        if "whole" in routes:
            ref["whole"] = _jax_whole(As)
        if "bounds" in routes:
            ref["bounds"] = jits.gershgorin_bounds(As)
        if "solves" in routes:
            ref["solves"] = _jax_solves(As, mesh, inp, solves)
        if "stationary" in routes:
            ref["stationary"] = _jax_stationary(As, mesh, inp)
        if "reduced" in routes:
            ref["reduced"] = _jax_reduced(As, mesh, inp, *extra["grid"])
        if "adjoint" in routes:
            W = A.with_adjoint()
            ref["adjoint"] = {
                "adj_data": np.asarray(W.adj.data),
                "adj_cols": np.asarray(W.adj.cols),
                "rmv": np.asarray(W.rmv(jnp.asarray(inp["y"])))}
        refs[name] = ref
    return refs


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """(every rank's outputs, the JAX package's answers, the record of
    ``graft_entry_torch.dryrun_multichip(4)`` over gloo on the CPU): the
    ranks and the dry run's ranks start first and run while this process
    computes the answers."""
    run = start(_rank_cases(), D, tmp_path_factory.mktemp("sharded"),
                timeout=PROCESS_TIMEOUT)
    with ThreadPoolExecutor(1) as pool:
        dry = pool.submit(graft_entry_torch.dryrun_multichip, D, "gloo",
                          "cpu")
        try:
            refs = _jax_refs()
        finally:
            ranks = run.wait()
        return ranks, refs, dry.result()


@pytest.fixture(scope="module")
def both(launches):
    return launches[:2]


def _out(ranks, case, route=None):
    pre = case + "/" + (route + "/" if route else "")
    return {k[len(pre):]: v for k, v in ranks[0].items() if k.startswith(pre)}


def _close(got, want, dtype):
    want = np.asarray(want)
    if dtype == F64:
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-13 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def _cases_with(route):
    return [n for n, c in CASES.items() if route in c[2]]


# ---- the tests ------------------------------------------------------------------

def test_shard_dia_and_shard_ell_return_the_sharded_formats(both):
    """shard_dia gives a RowShardedDIAMatrix (a DIAMatrix) on every rank,
    shard_ell a RowShardedELLOperator (an ELLMatrix), and every rank holds
    the same outputs of every route."""
    ranks, _ = both
    for name, (matrix, *_rest) in CASES.items():
        want = ("RowShardedELLOperator" if matrix.startswith("ell:")
                else "RowShardedDIAMatrix")
        assert str(_out(ranks, name)["type"]) == want, name
    assert issubclass(psh.RowShardedDIAMatrix, DIAMatrix)
    assert issubclass(psh.RowShardedELLOperator, ELLMatrix)
    for r in ranks[1:]:
        for k in ranks[0]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("name", _cases_with("products"))
def test_products_match_jax(both, name):
    """mv, rmv, mv_rows and (square) mv_dot against the JAX package's
    sharded matrix; a DIA mv issues one ranged fetch (counted as one
    collective-permute) on four ranks and nothing else; an ELL mv one
    all-gather."""
    ranks, refs = both
    got, want = _out(ranks, name, "products"), refs[name]["products"]
    dt = CASES[name][1]
    for key in ("mv", "rmv", "mv_rows"):
        _close(got[key], want[key], dt)
    if "mv_dot" in want:
        _close(got["mv_dot_y"], want["mv"], dt)
        _close(got["mv_dot"], want["mv_dot"], dt)
    if CASES[name][0].startswith("ell:"):
        assert int(got["mv/all-gather"]) == 1
        assert int(got["mv/collective-permute"]) == 0
    else:
        assert int(got["mv/collective-permute"]) == 1
        assert int(got["mv/all-gather"]) == int(got["mv/all-reduce"]) == 0


@pytest.mark.parametrize("name", _cases_with("whole"))
def test_whole_and_cast_forms_match_jax_bit_for_bit(both, name):
    """diagonal(), to_csr(), to_dense(), data and row_width whole on every
    rank, astype and compress_values to bf16 and int8 (sharded, the values
    gathered) and values_representable, bit for bit."""
    ranks, refs = both
    got, want = _out(ranks, name, "whole"), refs[name]["whole"]
    for key in ("csr_data", "csr_indices", "csr_indptr", "dense", "astype",
                "diagonal", "present", "data", "row_width"):
        if key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert str(got["astype_type"]) == str(_out(ranks, name)["type"])
    for key in ("bfloat16", "int8"):
        rep = bool(got[f"representable/{key}"])
        assert rep == want[f"representable/{key}"], key
        assert str(got[f"compress/{key}/dtype"]).split(".")[1] == (
            want[f"compress/{key}/dtype"]), key
        assert str(got[f"compress/{key}/type"]) == str(
            _out(ranks, name)["type"])
        np.testing.assert_array_equal(got[f"compress/{key}/values"],
                                      want[f"compress/{key}/values"],
                                      err_msg=key)
    if "row_width" in want:
        A = _jax_matrix(CASES[name][0])
        x = _inputs(name)["x"]
        _close(got["chunked_mv"], np.asarray(A.mv(jnp.asarray(x))), F64)


def test_laplacian_compresses_exactly(both):
    """The integer-valued Laplacian compresses to int8 (the narrowest exact
    type) on every rank; the coupled matrix's 6.6 is exact in neither."""
    ranks, _ = both
    lap = _out(ranks, "lap23", "whole")
    assert bool(lap["representable/int8"]) and bool(
        lap["representable/bfloat16"])
    assert str(lap["compress/int8/dtype"]) == "torch.int8"
    cpl = _out(ranks, "coupled", "whole")
    assert not bool(cpl["representable/bfloat16"])
    assert str(cpl["compress/bfloat16/dtype"]) == "torch.float64"


@pytest.mark.parametrize("name", _cases_with("bounds"))
def test_gershgorin_bounds_match_jax(both, name):
    """gershgorin_bounds from this rank's rows and one all-reduce: the JAX
    package's bounds exactly."""
    ranks, refs = both
    got = _out(ranks, name, "bounds")["gershgorin"]
    assert tuple(float(v) for v in got) == tuple(refs[name]["bounds"])


@pytest.mark.parametrize("name", _cases_with("power"))
def test_power_bound_on_a_mesh_matches_one_device(both, name):
    """power_bound on the sharded DIA (and on a HaloDIAOperator of the same
    matrix) from a seeded generator: the start vector drawn whole, norms
    and the quotient reduced over the mesh, so within 1e-12 of one
    device's power_bound from the same generator."""
    ranks, _ = both
    got = _out(ranks, name, "power")
    A1 = port_dia(_jax_dia(CASES[name][0]))
    want = float(pits.power_bound(A1, 20, key=torch.Generator().manual_seed(
        POWER_SEED)))
    assert abs(float(got["power"]) - want) <= 1e-12 * abs(want)
    if "halo_power" in got:
        assert abs(float(got["halo_power"]) - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("name", _cases_with("solves"))
def test_solves_match_jax(both, name):
    """CG, MINRES and LOBPCG on the square matrices (CG with IC(0) and
    GMRES with ILU(0), natural and multicolor, built from the sharded
    matrix), LSQR on the rectangular DIA and its ELL forms: equal steps, x,
    the residual series and eigenvalues within 1e-10.  LSQR's residual
    estimates on this inconsistent system reach their rounding floor, where
    the JAX package moves its own series by up to ~4e-5 under
    b (1 + 1e-15): that series is held within 1e-10 plus four times that
    spread, as ``tests/test_torch_parallel_rows.py`` holds LSQR."""
    ranks, refs = both
    got = _out(ranks, name, "solves")
    for solve, want in refs[name]["solves"].items():
        if solve == "lobpcg":
            assert int(got["lobpcg/iters"]) == want["iters"]
            assert rel(got["lobpcg/lam"], want["lam"]) <= 1e-10
            s = np.linalg.svd(got["lobpcg/X"].T @ want["X"],
                              compute_uv=False)
            assert np.abs(s - 1).max() <= 1e-8
            continue
        assert int(got[f"{solve}/iters"]) == want["iters"], solve
        assert rel(got[f"{solve}/x"], want["x"]) <= 1e-10, solve
        np.testing.assert_allclose(
            got[f"{solve}/resnorm"], want["resnorm"],
            rtol=1e-10 + 4 * want["spread"],
            atol=1e-12 * np.abs(want["resnorm"]).max(), err_msg=solve)


@pytest.mark.parametrize("name", _cases_with("stationary"))
def test_stationary_methods_match_jax(both, name):
    """Jacobi, Gauss-Seidel (natural and multicolor), SOR and SSOR, 5
    sweeps from the sharded matrix's whole CSR split, and SOR's iterable,
    within 1e-12."""
    ranks, refs = both
    got = _out(ranks, name, "stationary")
    for key, want in refs[name]["stationary"].items():
        assert rel(got[key], want) <= 1e-12, key


def test_reduced_system_and_block_jacobi_from_a_sharded_matrix(both):
    """RBReducedSystem.from_dia of the sharded laplace_dia(4, 3): the JAX
    package's streams; the block-Jacobi IC(0) and the red-black IC(0) built
    from it apply as the JAX package's."""
    ranks, refs = both
    got, want = _out(ranks, "lap43", "reduced"), refs["lap43"]["reduced"]
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-14, atol=1e-15,
                                   err_msg=key)


def test_ell_with_adjoint_matches_jax(both):
    """with_adjoint of the sharded rectangular ELL: the JAX package's
    adjoint arrays (each rank its rows, gathered) and its product."""
    ranks, refs = both
    got, want = _out(ranks, "ell_rect", "adjoint"), refs["ell_rect"][
        "adjoint"]
    np.testing.assert_array_equal(got["adj_data"], want["adj_data"])
    np.testing.assert_array_equal(got["adj_cols"], want["adj_cols"])
    _close(got["rmv"], want["rmv"], F64)


# the public names of DIAMatrix / ELLMatrix (and LinearOperator) whose
# inherited form is right on the sharded class, and the test that shows it:
# shape and dtype read the sharded class's own fields, mesh is set on every
# instance, H / T wrap its rmv / mv, ELL's mv_rows is the product of the
# columns Xr.T, and capturable is LinearOperator's no (only the halo stencil
# replays its steps)
INHERITED = {"shape": "test_products_match_jax",
             "dtype": "test_whole_and_cast_forms_match_jax_bit_for_bit",
             "mesh": "test_products_match_jax",
             "H": "test_solves_match_jax (LSQR)",
             "T": "test_solves_match_jax (LSQR)",
             "mv_rows": "test_products_match_jax",
             "capturable": "test_torch_halo_fold.py::"
                           "test_steps_replay_on_a_mesh_of_cards_over_nccl"}


@pytest.mark.parametrize("cls, base", [
    (psh.RowShardedDIAMatrix, DIAMatrix),
    (psh.RowShardedELLOperator, ELLMatrix)])
def test_sharded_classes_cover_every_public_method(cls, base):
    """Each public method or property of the port's DIAMatrix / ELLMatrix
    (and of LinearOperator) is overridden by the sharded class or its mesh
    base, or is one whose inherited form the tests above show right."""
    names = {n for klass in inspect.getmro(base) for n in vars(klass)
             if not n.startswith("_")}
    own = {n for klass in inspect.getmro(cls)
           if klass not in inspect.getmro(base) for n in vars(klass)}
    missing = sorted(names - own - set(INHERITED))
    assert not missing, f"{cls.__name__} inherits unchecked: {missing}"


def test_sharded_dia_guards():
    """n or m not divisible by D raises ValueError, as the JAX package's
    uneven device_put does; a panel of the wrong length raises too."""
    import types

    mesh = types.SimpleNamespace(size=4, rank=0, device=torch.device("cpu"),
                                 rows=lambda n: (0, n // 4))
    with pytest.raises(ValueError, match="divide evenly"):
        psh.shard_dia(port_dia(jits.DIAMatrix(
            [np.ones(64)], (0,), (64, 30))), mesh)
    with pytest.raises(ValueError, match="rows"):
        psh.RowShardedDIAMatrix([torch.ones(5)], (0,), (64, 64), mesh)


def test_fetch_plan_ranges():
    """The ranged fetch's plan of the coupled matrix on four ranks: each
    rank reads its Laplacian halos from its neighbours and one coupling
    block two ranks away, each range once."""
    n = 2 * 64
    plan = psh.FetchPlan(n, n, 4, (-64, -16, -4, -1, 0, 1, 4, 16, 64))
    assert plan.need[0] == [(32, 48), (64, 96)]
    assert plan.need[1] == [(16, 32), (64, 80), (96, 128)]
    assert plan.parts(0, 2) == [(64, 96)] and plan.parts(0, 3) == []
    assert plan.volume(3) == 16 + 32


# ---- graft_entry_torch.py ----------------------------------------------------------

def test_graft_entry_step_matches_jax():
    """entry() on the CPU: one CG step of the f32 laplace_dia(64, 2) from
    the same state as the JAX package's ``__graft_entry__.entry()``, x, r
    and the residual within f32 rounding of it."""
    import __graft_entry__

    fn, (state,) = graft_entry_torch.entry("cpu")
    got = fn(state)
    jfn, (jstate,) = __graft_entry__.entry()
    want = jax.jit(jfn)(jstate)
    for key in ("x", "r", "u"):
        w = np.asarray(getattr(want, key))
        np.testing.assert_allclose(to_numpy(getattr(got, key)), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=key)
    assert abs(float(got.residual) - float(want.residual)) <= 1e-6 * float(
        want.residual)


def test_graft_dryrun_multichip_on_four_gloo_ranks(launches):
    """dryrun_multichip(4, backend="gloo") on the CPU: every sharded run of
    ``__graft_entry__.py`` ran, each within its true-residual limit (the
    ranks check it and fail the dry run otherwise), shard_dia's CG on the
    row-sharded DIA matrix, the slice mesh's step included."""
    record = launches[2]
    assert set(record) == {
        "cg halo dia", "cg shard_dia", "gmres halo dia", "gmres dense padded",
        "cg rb reduced", "cg block-jacobi ic0", "lsqr row-sharded ell",
        "lobpcg halo dia", "svdl row-sharded ell", "cg halo stencil",
        "cg slice_mesh"}
    for name, r in record.items():
        assert r["true_residual"] <= r["limit"], name
    assert record["cg shard_dia"]["type"] == "RowShardedDIAMatrix"
    assert record["gmres dense padded"]["n"] % D != 0


def test_graft_entry_torch_imports_no_jax():
    """graft_entry_torch.py imports torch and the port, never JAX."""
    path = pathlib.Path(graft_entry_torch.__file__)
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "iterativesolvers_tpu"}, names
    assert "iterativesolvers_tpu_torch" in names
