"""The port's distributed path (``iterativesolvers_tpu_torch/parallel``,
GMRES's sharded-panel route, CG on a mesh operator) against the JAX package
on its 8-virtual-device CPU mesh.

The port runs one process per rank.  Every case runs in D rank processes of
``tests/_torch_dist.py`` over gloo on the CPU: subprocesses of
``sys.executable`` with a file rendezvous under a temporary directory,
inputs and outputs as ``.npz``, a timeout on each collective and on each
process.  All cases of one D run in one launch, once for the module.  The
JAX side runs on ``row_mesh(D)`` with the same D, so the panel layouts and
the partial sums match, with its panel kernels in interpret mode
(``po._PALLAS_INTERPRET``).

Tolerances: f64 rtol 1e-12 for products, 1e-10 for solutions and residual
series (equal step counts); f32 rtol 1e-6 with atol 1e-6 * max|y| for
products and 1e-5 relative for dots and the CGS2 sweeps (the port's stencil
and sweeps sum in other orders), solutions within 1e-4 and step counts
within 1 (GMRES) or 2 (CG), as the single-device f32 tests hold them.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import iterativesolvers_tpu as jits
import iterativesolvers_tpu.parallel.panel_ortho as jpo
from iterativesolvers_tpu.parallel import sharded as jsh
from iterativesolvers_tpu.solvers import gmres as jgm
from iterativesolvers_tpu.utils import fixtures as jfix

from _torch_dist import launch
from _torch_port import rel

# seconds a batch of rank processes may take before the test fails (each
# collective inside them times out after _torch_dist.COLLECTIVE_TIMEOUT)
PROCESS_TIMEOUT = 150

F64, F32 = np.float64, np.float32
STENCILS = {"laplacian(8,3)": lambda dt: jits.laplacian(8, 3, dtype=dt),
            "advection_diffusion_stencil(8)":
                lambda dt: jits.advection_diffusion_stencil(8, dtype=dt)}
DIAS = {"laplace_dia(8,3)": lambda: jfix.laplace_dia(8, 3, dtype=F64),
        "advection_diffusion(8)":
            lambda: jfix.advection_diffusion(8, dtype=F64)[0]}


# ---- the cases: port-side spec and inputs, the same numpy on both sides ----

def _stencil_spec(St):
    return {"kind": "stencil", "n": int(St.n), "center": float(St.center),
            "terms": [list(t) for t in St.terms],
            "coeffs": [float(c) for c in St.coeffs],
            "dtype": np.dtype(St.dtype).name}


def _dia_spec(A):
    spec = {"kind": "dia", "ndiags": len(A.diags),
            "offsets": [int(o) for o in A.offsets],
            "shape": [int(s) for s in A.shape]}
    return spec, {f"diag{i}": np.asarray(d) for i, d in enumerate(A.diags)}


def _x(n, dtype, seed=1):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _panel_inputs(n, D, m1, k, seed):
    """A global (m1, D*R, 512) f32 panel with orthonormal rows 0..k laid
    out per shard (each shard's first nloc entries, the last shard's rows
    past n zero), and a w (the inputs of test_parallel_stencil.py)."""
    lay = jpo.panel_layout(n, D)
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, k + 1)).astype(F32))
    V = np.zeros((m1, D * lay.R, 512), F32)
    for j in range(k + 1):
        col = np.zeros(lay.n_pad, F32)
        col[:n] = Q[:, j]
        pad = np.zeros((D, lay.R * 512), F32)
        pad[:, :lay.nloc] = col.reshape(D, lay.nloc)
        V[j] = pad.reshape(D * lay.R, 512)
    return V, rng.standard_normal(n).astype(F32), Q


PANELS = {  # name: (n, D, m1, k, panel dtype, passes)
    "f32": (4 * 700, 4, 6, 3, "float32", 2),
    "bf16": (4 * 512, 4, 4, 2, "bfloat16", 2),
    "f64": (4 * 700, 4, 6, 3, "float64", 2),
    "nondivisible_n": (1003, 4, 6, 3, "float32", 2),
    "one_pass": (4 * 700, 4, 6, 3, "float32", 1),
    "f32_D2": (2 * 700, 2, 6, 5, "float32", 2),
}

GMRES = {  # name: (operator, dtype, b, keywords)
    "stencil_f64": ("advection_diffusion_stencil(8)", F64,
                    dict(reltol=1e-8, restart=20, maxiter=400)),
    "stencil_f32": ("advection_diffusion_stencil(8)", F32,
                    dict(reltol=1e-5, restart=20, maxiter=400)),
    "stencil_bf16_panel": ("advection_diffusion_stencil(8)", F32,
                           dict(reltol=1e-4, restart=20, maxiter=400,
                                panel_dtype="bfloat16")),
    "dia_f64": ("laplace_dia(16,2)", F64,
                dict(reltol=1e-9, restart=20, maxiter=500)),
    "stencil_f32_cgs": ("laplacian(8,3)", F32,
                        dict(reltol=1e-5, restart=10, maxiter=200,
                             orth_method="cgs")),
}

CG = {  # name: (operator, dtype, keywords)
    "stencil_f64": ("laplacian(16,2)", F64, dict(reltol=1e-10, maxiter=600)),
    "stencil_f32": ("laplacian(16,2)", F32, dict(reltol=1e-5, maxiter=600)),
    "dia_f64": ("laplace_dia(16,2)", F64, dict(reltol=1e-10, maxiter=600)),
}

PIPECG = {  # name: (operator, dtype, keywords), on D = 2 ranks
    "stencil_f64": ("laplacian(16,2)", F64, dict(reltol=1e-9, maxiter=600)),
    "stencil_f32": ("laplacian(16,2)", F32, dict(reltol=1e-5, maxiter=600)),
}

# shard-local block-Jacobi on D = 2 ranks: name: (factor, ordering, matrix,
# CG keywords or None)
BJ = {
    "ilu natural": ("ilu", "natural", "advection_diffusion(8)", None),
    "ic natural": ("ic", "natural", "variable_diffusion(8,3)",
                   dict(reltol=1e-10, maxiter=500)),
    "ic multicolor": ("ic", "multicolor", "variable_diffusion(8,3)",
                      dict(reltol=1e-10, maxiter=500)),
}

GATES = [("float64", "mgs"), ("float32", "cgs2"), ("float32", "cgs"),
         ("float64", "dgks"), ("complex128", "mgs")]

# GMRES where the sharded-panel route does not apply, on D = 2 ranks:
# name: (operator, dtype, keywords)
FALLBACK = {
    "dgks_f64": ("advection_diffusion_stencil(8)", F64,
                 dict(reltol=1e-8, restart=20, maxiter=400,
                      orth_method="dgks")),
    "complex128": ("complex_stencil(8)", np.complex128,
                   dict(reltol=1e-8, restart=20, maxiter=400)),
}


def _complex_stencil():
    """laplacian(8, 3) with complex coefficients (not Hermitian)."""
    St = jits.laplacian(8, 3, dtype=np.complex128)
    coeffs = [-1.0 + 0.3j, -1.0 - 0.2j, -1.0 + 0.1j, -1.0, -1.0 - 0.4j, -1.0]
    return jits.StencilOperator(St.n, 6.0 + 0.5j, St.terms, coeffs,
                                dtype=np.complex128)


def _rb_reduced():
    """test_parallel.py's reduced system (side 16, 2-D, contrast 100) and
    its explicit DIA form."""
    A = jfix.variable_diffusion(16, 2, contrast=100, seed=4, dtype=F64)
    R = jits.RBReducedSystem.from_dia(A, 16, 2)
    return R, R.to_dia()


def _operator(name, dtype):
    """The JAX operator of a case and its port spec and arrays."""
    if name in STENCILS:
        St = STENCILS[name](dtype)
        return St, _stencil_spec(St), {}
    if name == "complex_stencil(8)":
        St = _complex_stencil()
        spec = {"kind": "stencil", "n": int(St.n),
                "terms": [list(t) for t in St.terms], "dtype": "complex128"}
        return St, spec, {"center": np.asarray(St.center),
                          "coeffs": np.asarray([np.asarray(c)
                                                for c in St.coeffs])}
    if name == "laplacian(16,2)":
        St = jits.laplacian(16, 2, dtype=dtype)
        return St, _stencil_spec(St), {}
    if name == "variable_diffusion(8,3)":
        A = jfix.variable_diffusion(8, 3, contrast=1e3, seed=5, dtype=F64)
    elif name == "rb_reduced(16,2).to_dia()":
        A = _rb_reduced()[1]
    else:
        A = (jfix.laplace_dia(16, 2, dtype=dtype)
             if name == "laplace_dia(16,2)" else DIAS[name]())
    spec, arrays = _dia_spec(A)
    return A, spec, arrays


def _cases(D):
    """The port's cases for a D-rank launch: [(case, arrays)]."""
    out = []
    if D in (1, 4):
        for name in STENCILS:
            for dt in (F64, F32):
                St, spec, _ = _operator(name, dt)
                out.append(({"name": f"halo/{name}/{dt.__name__}",
                             "kind": "halo_ops", "op": spec},
                            {"x": _x(St.n, dt)}))
    if D == 4:
        for name in DIAS:
            A, spec, arrays = _operator(name, F64)
            out.append(({"name": f"dia/{name}", "kind": "halo_ops",
                         "op": spec}, {**arrays, "x": _x(A.shape[0], F64)}))
        St, spec, _ = _operator("laplacian(8,3)", F64)
        out.append(({"name": "setup", "kind": "setup", "op": spec,
                     "gates": GATES}, {}))
        for name, (opname, dt, kw) in GMRES.items():
            A, spec, arrays = _operator(opname, dt)
            out.append(({"name": f"gmres/{name}", "kind": "gmres", "op": spec,
                         "kw": kw}, {**arrays, "b": np.ones(A.shape[0], dt)}))
        for name, (opname, dt, kw) in CG.items():
            A, spec, arrays = _operator(opname, dt)
            out.append(({"name": f"cg/{name}", "kind": "cg", "op": spec,
                         "kw": kw}, {**arrays, "b": np.ones(A.shape[0], dt)}))
    if D == 2:
        for name, (opname, dt, kw) in FALLBACK.items():
            A, spec, arrays = _operator(opname, dt)
            out.append(({"name": f"fallback/{name}", "kind": "gmres",
                         "op": spec, "kw": kw},
                        {**arrays, "b": np.ones(A.shape[0], dt)}))
        for name, (opname, dt, kw) in PIPECG.items():
            A, spec, arrays = _operator(opname, dt)
            out.append(({"name": f"pipecg/{name}", "kind": "pipecg",
                         "op": spec, "kw": kw},
                        {**arrays, "b": np.ones(A.shape[0], dt)}))
        for name, (factor, ordering, opname, kw) in BJ.items():
            A, spec, arrays = _operator(opname, F64)
            case = {"name": f"bj/{name}", "kind": "bjacobi", "op": spec,
                    "factor": factor, "ordering": ordering}
            if kw is not None:
                case["kw"] = kw
            out.append((case, {**arrays, "x": _x(A.shape[0], F64),
                               "b": np.ones(A.shape[0])}))
        R, S = _rb_reduced()
        _, spec, arrays = _operator("rb_reduced(16,2).to_dia()", F64)
        bb = np.asarray(R.reduce_rhs(jnp.ones(256))[0])
        out.append(({"name": "cg/rb_reduced_dia", "kind": "cg", "op": spec,
                     "kw": dict(reltol=1e-11, maxiter=2000)}, {**arrays,
                                                               "b": bb}))
    if D in (2, 4):
        for name in STENCILS:
            for dt in (F64, F32):
                St, spec, _ = _operator(name, dt)
                out.append(({"name": f"interior/{name}/{dt.__name__}",
                             "kind": "interior", "op": spec},
                            {"x": _x(St.n, dt)}))
    for name, (n, Dp, m1, k, pd, passes) in PANELS.items():
        if Dp == D:
            V, w, _ = _panel_inputs(n, D, m1, k, seed=len(name))
            if pd == "float64":
                V, w = V.astype(F64), w.astype(F64)
            out.append(({"name": f"panel/{name}", "kind": "panel", "n": n,
                         "m1": m1, "k": k, "panel": pd, "passes": passes},
                        {"V": V, "w": w}))
    if D == 1:
        _, spec, _ = _operator("advection_diffusion_stencil(8)", F32)
        out.append(({"name": "gmres/single_rank", "kind": "gmres", "op": spec,
                     "kw": dict(reltol=1e-5, restart=20, maxiter=400)},
                    {"b": np.ones(512, F32)}))
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """``port(D)``: every rank's outputs of the D-rank launch (run once; a
    launch that failed fails every later call at once, without running
    again)."""
    done = {}

    def get(D):
        if D not in done:
            try:
                done[D] = launch(_cases(D), D,
                                 tmp_path_factory.mktemp(f"ranks{D}"),
                                 timeout=PROCESS_TIMEOUT)
            except AssertionError as e:
                done[D] = e
        if isinstance(done[D], AssertionError):
            raise AssertionError(f"the {D}-rank launch failed (once):\n"
                                 f"{done[D]}")
        return done[D]

    return get


def _out(ranks, case):
    """Rank 0's outputs of a case, keys without the case prefix."""
    pre = case + "/"
    return {k[len(pre):]: v for k, v in ranks[0].items() if k.startswith(pre)}


def _mesh(D):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jsh.row_mesh(D)


def _jit(f, op, x):
    """``f(op, x)`` compiled: a shard_map run eagerly takes tens of seconds
    on the CPU mesh."""
    return jax.jit(f)(op, x)


def _close(got, want, dtype):
    want = np.asarray(want)
    if dtype == F64:
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-13 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def _close_dot(got, want, dtype):
    tol = 1e-12 if dtype == F64 else 1e-5
    assert abs(float(got) - float(want)) <= tol * abs(float(want))


# ---- the halo operators ------------------------------------------------------

@pytest.mark.parametrize("D", [4, 1])
@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("name", list(STENCILS))
def test_halo_stencil_mv_rmv_mv_dot_match_jax(port, name, dtype, D):
    """D = 4 over laplacian(8,3) (n_local = 128) meets all three span
    classes: spans 8 and 64 divide n_local, 512 is a multiple of it."""
    got = _out(port(D), f"halo/{name}/{dtype.__name__}")
    St = STENCILS[name](dtype)
    op = jsh.HaloStencilOperator(St, _mesh(D))
    x = jsh.shard_vector(jnp.asarray(_x(St.n, dtype)), _mesh(D))
    mv, rmv, y, d = _jit(lambda o, v: (o.mv(v), o.rmv(v), *o.mv_dot(v)),
                         op, x)
    _close(got["mv"], mv, dtype)
    _close(got["rmv"], rmv, dtype)
    _close(got["mv_dot_y"], y, dtype)
    _close_dot(got["mv_dot"], d, dtype)


@pytest.mark.parametrize("name", list(DIAS))
def test_halo_dia_mv_rmv_match_jax(port, name):
    got = _out(port(4), f"dia/{name}")
    A = DIAS[name]()
    op = jsh.HaloDIAOperator(A, _mesh(4))
    x = jsh.shard_vector(jnp.asarray(_x(A.shape[0], F64)), _mesh(4))
    mv, rmv = _jit(lambda o, v: (o.mv(v), o.rmv(v)), op, x)
    _close(got["mv"], mv, F64)
    _close(got["rmv"], rmv, F64)
    _close(got["mv_dot_y"], mv, F64)
    _close_dot(got["mv_dot"], jnp.vdot(x, mv), F64)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("name", list(STENCILS))
def test_halo_stencil_interior_matches_jax_local_interior(port, name, dtype,
                                                         D):
    """The shard-local interior of each rank, the port's stencil kernel
    (its plain version here) on the block with ``n = n_local``, against
    the JAX package's ``_local_interior`` shard by shard: the kernel's
    zero reads outside ``[0, n_local)`` and local masks give the outermost
    term's shard-edge behaviour (span 512 over n_local 128 and 256)."""
    got = _out(port(D), f"interior/{name}/{dtype.__name__}")
    St = STENCILS[name](dtype)
    op = jsh.HaloStencilOperator(St, _mesh(D))
    x = _x(St.n, dtype)
    nl = op.n_local
    for conj in (False, True):
        eff = tuple((-o if conj else o, s, e) for (o, s, e) in op.terms)
        cs = [jnp.conj(c) if conj else c for c in op.coeffs]
        center = jnp.conj(op.center) if conj else op.center
        interior = jax.jit(lambda v, eff=eff, cs=cs, center=center:
                           op._local_interior(eff, cs, center, v))
        want = np.concatenate([
            np.asarray(interior(jnp.asarray(x[r * nl:(r + 1) * nl])))
            for r in range(D)])
        _close(got[f"conj{int(conj)}"], want, dtype)


# ---- dist_panel_ortho ----------------------------------------------------------

@pytest.mark.parametrize("name", list(PANELS))
def test_dist_panel_ortho_matches_jax(port, name):
    """The cases of test_parallel_stencil.py (f32 and bf16 panels) and of a
    non-divisible n (test_parallel.py's zero-padded last shard), with the
    JAX sweeps as Pallas kernels in interpret mode; an f64 panel takes the
    gemv sweeps in both packages.  The f32 sweeps are the kernels' plain
    versions here and each pass calls each sweep once."""
    n, D, m1, k, pd, passes = PANELS[name]
    got = _out(port(D), f"panel/{name}")
    V, w, Q = _panel_inputs(n, D, m1, k, seed=len(name))
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "float64": jnp.float64}[pd]
    if pd == "float64":
        w = w.astype(F64)
    mesh = _mesh(D)
    Vj = jax.device_put(jnp.asarray(V, jdt),
                        NamedSharding(mesh, P(None, "rows", None)))
    old = jpo._PALLAS_INTERPRET
    jpo._PALLAS_INTERPRET = pd != "float64"
    try:
        w2d, h, nrm = jpo.dist_panel_ortho(Vj, jnp.asarray(w), jnp.int32(k),
                                           m1, mesh, ("rows",),
                                           jpo.panel_layout(n, D),
                                           passes=passes)
    finally:
        jpo._PALLAS_INTERPRET = old
    tol = 1e-12 if pd == "float64" else 1e-5
    assert got["dtype"] == ("torch.float64" if pd == "float64"
                            else "torch.float32")
    np.testing.assert_allclose(got["h"], np.asarray(h), rtol=tol,
                               atol=tol * np.linalg.norm(w))
    assert abs(float(got["nrm"]) - float(nrm)) <= tol * float(nrm)
    _close(got["w2d"], np.asarray(w2d), F64 if pd == "float64" else F32)
    assert not got["h"][k + 1:].any()
    kernels = pd != "float64"
    assert (int(got["calls/panel_dots"]), int(got["calls/panel_update"])) \
        == ((passes, passes) if kernels else (0, 0))


# ---- distributed GMRES and CG ---------------------------------------------------

def _jax_halo(name, dtype, mesh):
    A, _, _ = _operator(name, dtype)
    if isinstance(A, jits.DIAMatrix):
        return jsh.HaloDIAOperator(A, mesh)
    return jsh.HaloStencilOperator(A, mesh)


@pytest.mark.parametrize("name", list(GMRES))
def test_gmres_dist_matches_jax(port, name):
    """Distributed GMRES on 4 ranks against the JAX package's sharded-panel
    route on row_mesh(4): f64 to equal counts and 1e-10, f32 (kernels) and
    the bf16-panel IR mode within 1 step and 1e-4 in x.  Each Arnoldi step
    runs one distributed CGS2 (two passes of both sweeps in f32)."""
    opname, dtype, kw = GMRES[name]
    got = _out(port(4), f"gmres/{name}")
    mesh = _mesh(4)
    op = _jax_halo(opname, dtype, mesh)
    jkw = dict(kw)
    if "panel_dtype" in jkw:
        jkw["panel_dtype"] = jnp.bfloat16
    b = jsh.shard_vector(jnp.ones(op.shape[0], dtype), mesh)
    old = jpo._PALLAS_INTERPRET
    jpo._PALLAS_INTERPRET = dtype == F32
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            x, h = jits.gmres(op, b, log=True, **jkw)
    finally:
        jpo._PALLAS_INTERPRET = old
    assert h.isconverged and bool(got["converged"])
    # one orthogonalization a step, masked steps included: restart a cycle
    steps = int(got["calls/dist_panel_ortho"])
    assert steps == kw["restart"] * (int(got["restarts"]) + 1)
    assert int(got["calls/panel_mgs"]) == int(got["calls/fused_arnoldi"]) == 0
    if dtype == F64:
        assert (int(got["iters"]), int(got["mvps"]), int(got["restarts"])) \
            == (h.iters, h.mvps, h.restarts)
        # atol: the last residuals reach rounding level of |r0|
        np.testing.assert_allclose(got["resnorm"], h["resnorm"], rtol=1e-10,
                                   atol=1e-12 * h["resnorm"][0])
        assert rel(got["x"], np.asarray(x)) <= 1e-10
        assert int(got["calls/panel_dots"]) == 0
    else:
        assert abs(int(got["iters"]) - h.iters) <= 1
        assert rel(got["x"], np.asarray(x)) <= 1e-4
        assert int(got["calls/panel_dots"]) == 2 * steps
        assert int(got["calls/panel_update"]) == 2 * steps
    jwarn = [str(w.message) for w in caught if "mesh operator" in
             str(w.message)]
    pwarn = [m for m in got["warnings"] if m]
    assert pwarn == jwarn


@pytest.mark.parametrize("name", list(CG))
def test_cg_dist_matches_jax(port, name):
    """Distributed CG on 4 ranks (its reductions allreduced over the mesh,
    mv_dot's dot with the halo corrections) against the JAX package's CG on
    the same halo operator: f64 equal steps and 1e-10, f32 within 2 steps
    and 1e-4."""
    opname, dtype, kw = CG[name]
    got = _out(port(4), f"cg/{name}")
    mesh = _mesh(4)
    op = _jax_halo(opname, dtype, mesh)
    x, h = jits.cg(op, jsh.shard_vector(jnp.ones(op.shape[0], dtype), mesh),
                   log=True, **kw)
    assert h.isconverged and bool(got["converged"])
    if dtype == F64:
        assert int(got["iters"]) == h.iters
        np.testing.assert_allclose(got["resnorm"], h["resnorm"], rtol=1e-10,
                                   atol=1e-12 * h["resnorm"][0])
        assert rel(got["x"], np.asarray(x)) <= 1e-10
    else:
        assert abs(int(got["iters"]) - h.iters) <= 2
        assert rel(got["x"], np.asarray(x)) <= 1e-4


@pytest.mark.parametrize("name", list(PIPECG))
def test_pipelined_cg_dist_matches_single_process(port, name):
    """Pipelined CG on 2 ranks reduces its step's three dots in ONE
    allreduce (one more for the first norm; masked steps of run_chunked
    included), and matches the JAX package's and the port's single-process
    pipelined CG: f64 equal steps, x within 1e-10 and the lagged residual
    series as tests/test_torch_krylov.py holds it (1e-8 relative above
    1e-6 |r0|, 1e-14 |r0| down to 1e-12 |r0|: each recurrence carries a
    rounding of ~eps |r0|); f32 within 2 steps and 1e-4."""
    from iterativesolvers_tpu_torch.solvers.common import chunked_steps

    import iterativesolvers_tpu_torch as pits
    from _torch_port import port_stencil, to_numpy

    opname, dtype, kw = PIPECG[name]
    ranks = port(2)
    got = _out(ranks, f"pipecg/{name}")
    steps = chunked_steps(int(got["iters"]))
    assert int(got["allreduces"]) == 1 + steps
    for r in ranks[1:]:
        assert int(r[f"pipecg/{name}/allreduces"]) == 1 + steps
    St = jits.laplacian(16, 2, dtype=dtype)
    b = np.ones(St.n, dtype)
    xj, hj = jits.pipelined_cg(St, b, log=True, **kw)
    xp, hp = pits.pipelined_cg(port_stencil(St), b, log=True, **kw)
    assert bool(got["converged"]) and hj.isconverged and hp.isconverged
    for x, h in ((np.asarray(xj), hj), (to_numpy(xp), hp)):
        if dtype == F64:
            assert int(got["iters"]) == h.iters
            rj, r0 = np.asarray(h["resnorm"]), float(np.linalg.norm(b))
            big, mid = rj > 1e-6 * r0, rj > 1e-12 * r0
            np.testing.assert_allclose(got["resnorm"][big], rj[big],
                                       rtol=1e-8)
            np.testing.assert_allclose(got["resnorm"][mid], rj[mid], rtol=0,
                                       atol=1e-14 * r0)
            assert rel(got["x"], x) <= 1e-10
        else:
            assert abs(int(got["iters"]) - h.iters) <= 2
            assert rel(got["x"], x) <= 1e-4


def test_ranks_hold_the_same_replicated_state(port):
    """Every rank's solve took the same steps with the same residual series
    and gathered the same x: the replicated state is computed from
    allreduced values only, so the once-a-cycle host read agrees."""
    ranks = port(4)
    keys = [k for k in ranks[0] if k.startswith(("gmres/", "cg/"))]
    assert keys
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def test_dist_panel_setup_gates_match_jax(port):
    """The sharded-panel gates of ``_dist_panel_setup``: where JAX takes the
    route the port does; where JAX falls back to GSPMD orthogonalization
    (dgks, complex), with a warning, the port returns None too and its
    GMRES orthogonalizes through the mesh-aware ``ops/orthogonalize.py``
    (``test_gmres_dist_fallback_matches_jax``)."""
    got = _out(port(4), "setup")
    St = jits.laplacian(8, 3, dtype=F64)
    op = jsh.HaloStencilOperator(St, _mesh(4))
    for dt, orth in GATES:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            want = jgm._dist_panel_setup(op, St.n, jnp.dtype(dt), orth,
                                         warn=True, explicit=False)
        res = str(got[f"{dt}/{orth}"])
        if want is not None:
            assert res == "dist"
        else:
            assert any("falling back to GSPMD" in str(w.message)
                       for w in caught)
            assert res == "none"


@pytest.mark.parametrize("name", list(FALLBACK))
def test_gmres_dist_fallback_matches_jax(port, name):
    """GMRES(20) on 2 ranks with orth_method='dgks' (f64 halo stencil) and
    on a complex128 halo stencil, where the sharded-panel route does not
    apply: the port orthogonalizes each rank's rows through
    ``ops/orthogonalize.py`` with the mesh's allreduces, the JAX package
    through GSPMD on row_mesh(2).  Equal step, product and restart counts,
    the residual series within 1e-10 relative down to 1e-12 |r0|, x within
    1e-10; no panel kernel ran, and each package warned of its fallback."""
    opname, dtype, kw = FALLBACK[name]
    got = _out(port(2), f"fallback/{name}")
    mesh = _mesh(2)
    St = _operator(opname, dtype)[0]
    op = jsh.HaloStencilOperator(St, mesh)
    b = jsh.shard_vector(jnp.ones(op.shape[0], dtype), mesh)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        x, h = jits.gmres(op, b, log=True, **kw)
    assert h.isconverged and bool(got["converged"])
    assert (int(got["iters"]), int(got["mvps"]), int(got["restarts"])) \
        == (h.iters, h.mvps, h.restarts)
    np.testing.assert_allclose(got["resnorm"], h["resnorm"], rtol=1e-10,
                               atol=1e-12 * h["resnorm"][0])
    assert rel(got["x"], np.asarray(x)) <= 1e-10
    for k in ("dist_panel_ortho", "panel_mgs", "fused_arnoldi",
              "panel_dots", "panel_update"):
        assert int(got[f"calls/{k}"]) == 0
    assert any("falling back to GSPMD" in str(w.message) for w in caught)
    assert any("falling back to mesh-reduced" in m for m in got["warnings"])


def test_single_rank_mesh_takes_single_device_routes(port):
    """D = 1: the sharded-panel route does not apply (gmres.py:175), so an
    f32 solve on a one-rank halo stencil takes op.mv and panel MGS, and
    agrees with JAX's single-device solve."""
    got = _out(port(1), "gmres/single_rank")
    St = jits.advection_diffusion_stencil(8, dtype=F32)
    op = jsh.HaloStencilOperator(St, _mesh(1))
    assert jgm._dist_panel_setup(op, St.n, jnp.float32, "mgs") is None
    assert int(got["calls/dist_panel_ortho"]) == 0
    assert int(got["calls/panel_mgs"]) == 20 * (int(got["restarts"]) + 1)
    x, h = jits.gmres(St, jnp.ones(St.n, F32), reltol=1e-5, restart=20,
                      maxiter=400, log=True)
    assert abs(int(got["iters"]) - h.iters) <= 1
    assert rel(got["x"], np.asarray(x)) <= 1e-4


# ---- shard-local block-Jacobi and the reduced system on a mesh ----------------

@pytest.mark.parametrize("name", list(BJ))
def test_sharded_block_jacobi_matches_jax(port, name):
    """ShardedBlockJacobiPreconditioner on 2 ranks, each rank factoring only
    its diagonal block: ldiv within 1e-12 of the JAX package's sharded
    preconditioner on row_mesh(2) and, for ILU, of
    ``ILUPreconditioner.block_jacobi(csr, 2)`` on one device; nlevels equal
    (the maximum over the ranks); CG with it as ``Pl`` on the halo DIA
    operator takes the JAX package's steps with its residual series within
    1e-10."""
    from iterativesolvers_tpu.operators.preconditioners import (
        ILUPreconditioner)
    from iterativesolvers_tpu.parallel.precond import (
        ShardedBlockJacobiPreconditioner)

    factor, ordering, opname, kw = BJ[name]
    ranks = port(2)
    got = _out(ranks, f"bj/{name}")
    A = _operator(opname, F64)[0]
    csr = A.to_csr()
    mesh = _mesh(2)
    P = getattr(ShardedBlockJacobiPreconditioner, factor)(csr, mesh,
                                                         ordering=ordering)
    x = _x(A.shape[0], F64)
    want = np.asarray(P.ldiv(jsh.shard_vector(jnp.asarray(x), mesh)))
    assert rel(got["ldiv"], want) <= 1e-12
    assert int(got["nlevels"]) == P.nlevels
    assert max(int(r[f"bj/{name}/local_nlevels"]) for r in ranks) \
        == P.nlevels
    if factor == "ilu":
        one = ILUPreconditioner.block_jacobi(csr, 2)
        assert rel(got["ldiv"], np.asarray(one.ldiv(jnp.asarray(x)))) \
            <= 1e-12
    if kw is not None:
        op = jsh.HaloDIAOperator(A, mesh)
        xj, h = jits.cg(op, jsh.shard_vector(jnp.ones(A.shape[0]), mesh),
                        Pl=P, log=True, **kw)
        assert h.isconverged and bool(got["converged"])
        assert int(got["iters"]) == h.iters
        np.testing.assert_allclose(got["resnorm"], h["resnorm"], rtol=1e-10,
                                   atol=1e-12 * h["resnorm"][0])
        assert rel(got["x"], np.asarray(xj)) <= 1e-10


def test_rb_reduced_to_dia_on_a_mesh_matches_jax(port):
    """The reduced system's explicit DIA form (test_parallel.py:487-514) in
    a halo DIA operator on 2 ranks: CG takes the JAX package's steps on
    row_mesh(2), and its x solves the one-device reduced system."""
    got = _out(port(2), "cg/rb_reduced_dia")
    R, S = _rb_reduced()
    mesh = _mesh(2)
    bb = R.reduce_rhs(jnp.ones(256))[0]
    xj, h = jits.cg(jsh.HaloDIAOperator(S, mesh), jsh.shard_vector(bb, mesh),
                    reltol=1e-11, maxiter=2000, log=True)
    assert h.isconverged and bool(got["converged"])
    assert int(got["iters"]) == h.iters
    assert rel(got["x"], np.asarray(xj)) <= 1e-10
    xb_ref = jits.cg(R, bb, reltol=1e-11, maxiter=2000)
    assert rel(got["x"], np.asarray(xb_ref)) <= 1e-8
