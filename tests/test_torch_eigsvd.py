"""The port's LOBPCG and svdl against the JAX package's, on the CPU, on the
same inputs (numpy, seeded).

The JAX package's svdl runs in a fresh interpreter (this file run as a
script, once for the module): XLA-CPU crashes when svdl's compilations come
after a few hundred others in one process (``tests/conftest.py``), so its
references are made apart from the rest of the run, all cases in one go.

Tolerances: f64 and complex128 equal iteration counts, eigen- and singular
values and histories within 1e-10 relative, vectors (up to the sign or
phase of each, or as a subspace) within 1e-10; LOBPCG's residual norms
and their history within 1e-10 relative or 0.1 tol (the last ones lie far
below tol, where the rounding of the packages' other sum orders and of the
port's CholQR transform, an inverse times the panel, shows); f32 and
complex64 iterations within 2 and values within 1e-4 relative.  Where a case depends on a random draw the packages make
differently (LOBPCG's later ``nev > blocksize`` batches: ``PRNGKey(42)``
against a ``torch.Generator`` seeded 42), the values are held to 1e-10 and
the vectors to their properties (B-orthonormal, the residual below tol).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.solvers import lobpcg as plob
from iterativesolvers_tpu_torch.utils import convert

from _torch_port import CPU, port_dia, port_stencil, rel, to_numpy, to_torch

torch.set_num_threads(1)

F64, F32, C64, C128 = np.float64, np.float32, np.complex64, np.complex128


def _exact(dtype):
    return np.dtype(dtype) in (np.dtype(F64), np.dtype(C128))


def _randn(rng, shape, dtype):
    X = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        X = X + 1j * rng.standard_normal(shape)
    return X.astype(dtype)


def _spectrum_matrix(rng, n, dtype, lo=1.0, hi=10.0):
    """A Hermitian matrix with eigenvalues in [lo, hi]: 4 at each end
    spaced by (hi - lo) / 40, the rest spread over the middle half, so
    that a block of up to 4 at either end converges in few steps, where
    rounding has little room to grow between the packages."""
    Q, _ = np.linalg.qr(_randn(rng, (n, n), dtype))
    d = (hi - lo) / 40
    w = np.concatenate([lo + d * np.arange(4),
                        np.linspace(lo + (hi - lo) / 4, hi - (hi - lo) / 4,
                                    n - 8),
                        hi - d * np.arange(4)[::-1]])
    return ((Q * w) @ Q.conj().T).astype(dtype)


def _same_span(Xp, Xj, B=None, tol=1e-10):
    """The column spaces of Xp and Xj (each B-orthonormal) agree: every
    singular value of Xp^H B Xj is 1 within tol."""
    Xp, Xj = to_numpy(Xp), np.asarray(Xj)
    G = Xp.conj().T @ (Xj if B is None else B @ Xj)
    s = np.linalg.svd(G, compute_uv=False)
    assert np.abs(s - 1).max() <= tol, s


# ---- LOBPCG ------------------------------------------------------------------

def _jax():
    import jax.numpy as jnp

    import iterativesolvers_tpu as jits
    from iterativesolvers_tpu.operators import preconditioners as jprec
    return jits, jnp, jprec


def _check_lobpcg(rp, rj, dtype, B=None, same_steps=True):
    assert rp.converged == rj.converged
    lam_p, lam_j = to_numpy(rp.lam), np.asarray(rj.lam)
    if _exact(dtype):
        if same_steps:
            assert rp.iterations == rj.iterations
            assert rp.batch_iterations == rj.batch_iterations
            np.testing.assert_allclose(to_numpy(rp.residual_norms),
                                       np.asarray(rj.residual_norms),
                                       rtol=1e-10, atol=0.1 * rj.tolerance)
            _same_span(rp.X, rj.X, B)
        assert rel(lam_p, lam_j) <= 1e-10
    else:
        assert abs(rp.iterations - rj.iterations) <= 2
        assert rel(lam_p, lam_j) <= 1e-4
    X = to_numpy(rp.X)
    G = X.conj().T @ (X if B is None else B @ X)
    np.testing.assert_allclose(G, np.eye(X.shape[1]),
                               atol=1e-8 if _exact(dtype) else 1e-4)
    assert rp.tolerance == rj.tolerance and rp.maxiter == rj.maxiter


LOBPCG = {  # name: (dtype, largest, keywords)
    "smallest f64": (F64, False, dict(tol=1e-9)),
    "largest f64": (F64, True, dict(tol=1e-9)),
    "smallest f32": (F32, False, dict()),
    "largest complex128": (C128, True, dict(tol=1e-9)),
    "smallest complex128": (C128, False, dict(tol=1e-9)),
    "smallest complex64": (C64, False, dict()),
}


@pytest.mark.parametrize("name", list(LOBPCG))
def test_lobpcg_standard_matches_jax(rng, name):
    """tests/test_lobpcg.py's standard and complex problems, on a spectrum
    with distinct eigenvalues (n = 40, blocksize 3: one shape across the
    module, so the JAX side compiles few programs), with the history."""
    jits, jnp, _ = _jax()
    dtype, largest, kw = LOBPCG[name]
    n, k = 40, 3
    A = _spectrum_matrix(rng, n, dtype)
    X0 = _randn(rng, (n, k), dtype)
    rj = jits.lobpcg(jnp.asarray(A), jnp.asarray(X0), largest=largest,
                     maxiter=300, log=True, **kw)
    rp = pits.lobpcg(to_torch(A), to_torch(X0), largest=largest, maxiter=300,
                     log=True, **kw)
    assert isinstance(rp, pits.LOBPCGResults) and rp.X.shape == (n, k)
    assert rp.converged
    _check_lobpcg(rp, rj, dtype)
    hp, hj = rp.history, rj.history
    assert (hp.iters, hp.isconverged) == (hj.iters, hj.isconverged)
    assert hp["batch_iters"] == hj["batch_iters"] and hp["tol"] == hj["tol"]
    if _exact(dtype):
        np.testing.assert_allclose(hp["resnorm"], np.asarray(hj["resnorm"]),
                                   rtol=1e-10, atol=0.1 * rj.tolerance)


def test_lobpcg_generalized_constraints_and_preconditioner(rng):
    """A x = lam B x with a diagonal B (real) and a Hermitian positive
    definite B (complex), constraints C, and a dense preconditioner P."""
    jits, jnp, jprec = _jax()
    n, k = 40, 3
    for dtype in (F64, C128):
        A = _spectrum_matrix(rng, n, dtype, 2.0, 30.0)
        B = (np.diag(rng.random(n) + 1.0).astype(dtype) if dtype == F64
             else _spectrum_matrix(rng, n, dtype, 1.0, 3.0))
        X0 = _randn(rng, (n, k), dtype)
        rj = jits.lobpcg(jnp.asarray(A), jnp.asarray(X0), B=jnp.asarray(B),
                         tol=1e-9, maxiter=500)
        rp = pits.lobpcg(to_torch(A), to_torch(X0), B=to_torch(B), tol=1e-9,
                         maxiter=500)
        _check_lobpcg(rp, rj, dtype, B=B)
    A = _spectrum_matrix(rng, n, F64)
    w, V = np.linalg.eigh(A)
    C = V[:, :2]
    X0 = rng.random((n, 2))
    rj = jits.lobpcg(jnp.asarray(A), jnp.asarray(X0), C=jnp.asarray(C),
                     tol=1e-9, maxiter=500)
    rp = pits.lobpcg(to_torch(A), to_torch(X0), C=to_torch(C), tol=1e-9,
                     maxiter=500)
    _check_lobpcg(rp, rj, F64)
    np.testing.assert_allclose(np.sort(to_numpy(rp.lam)), w[2:4], rtol=1e-8)
    assert np.abs(C.T @ to_numpy(rp.X)).max() < 1e-8
    M = A + 0.1 * np.diag(rng.random(n))
    rj = jits.lobpcg(jnp.asarray(A), jnp.asarray(X0),
                     P=jprec.DensePreconditioner(jnp.asarray(M)), tol=1e-9)
    rp = pits.lobpcg(to_torch(A), to_torch(X0),
                     P=pits.DensePreconditioner(to_torch(M), device=CPU),
                     tol=1e-9)
    _check_lobpcg(rp, rj, F64)


def test_lobpcg_nev_greater_than_blocksize(rng):
    """nev = 6 in batches of 2: the first batch starts from the same X0 in
    both packages (the same steps); the later ones from each package's own
    draw.  The eigenvalues agree within 1e-10 and the eigenvectors are
    orthonormal across batches."""
    jits, jnp, _ = _jax()
    n = 40
    A = _spectrum_matrix(rng, n, F64)
    X0 = rng.random((n, 2))
    rj = jits.lobpcg(jnp.asarray(A), jnp.asarray(X0), nev=6, tol=1e-10,
                     maxiter=500, log=True)
    rp = pits.lobpcg(to_torch(A), to_torch(X0), nev=6, tol=1e-10,
                     maxiter=500, log=True)
    assert rp.converged and rj.converged
    assert len(rp.batch_iterations) == 3
    assert rp.batch_iterations[0] == rj.batch_iterations[0]
    assert rp.history["batch_iters"] == rp.batch_iterations
    assert rel(to_numpy(rp.lam), np.asarray(rj.lam)) <= 1e-10
    np.testing.assert_allclose(to_numpy(rp.lam), np.linalg.eigvalsh(A)[:6],
                               rtol=1e-10)
    X = to_numpy(rp.X)
    np.testing.assert_allclose(X.T @ X, np.eye(6), atol=1e-8)
    assert np.linalg.norm(A @ X - X * to_numpy(rp.lam)) < 6 * 1e-8


@pytest.mark.parametrize("dtype", [F64, F32])
def test_lobpcg_on_the_port_operators(rng, dtype):
    """The stencil and the DIA matrix through ``mv_rows`` (in f32, and on
    int8 diagonals, the kernels' routes: their plain versions here): the
    Laplacian of a 12 x 13 grid (distinct eigenvalues), 3 smallest."""
    jits, jnp, _ = _jax()

    St = jits.StencilOperator(
        156, 4.0, ((1, 1, 12), (-1, 1, 12), (12, 12, 13), (-12, 12, 13)),
        [-1.0] * 4, dtype=dtype)
    A = St.to_dia()
    X0 = rng.random((156, 3)).astype(dtype)
    kw = dict(tol=1e-8 if dtype == F64 else 1e-4, maxiter=400)
    rj = jits.lobpcg(A, jnp.asarray(X0), **kw)
    ops = [port_dia(A), port_stencil(St)]
    if dtype == F32:
        ops.append(port_dia(jits.compress_values(A, jnp.int8)))
        assert ops[-1].dtype == torch.int8
    for op in ops:
        rp = pits.lobpcg(op, to_torch(X0), **kw)
        assert rp.converged
        _check_lobpcg(rp, rj, dtype)


def test_lobpcg_iterator_steps_as_the_solve(rng):
    """One next() a LOBPCG iteration: the stepped state gives the one-shot
    solve's Ritz values and block (the unmasked steps, the same numbers),
    and the JAX package's iterator takes as many steps."""
    jits, jnp, _ = _jax()
    n, k = 40, 3
    A = _spectrum_matrix(rng, n, F64)
    X0 = rng.random((n, k))
    it = pits.lobpcg_iterator(to_torch(A), to_torch(X0), tol=1e-9)
    steps = list(it)
    jt = jits.lobpcg_iterator(jnp.asarray(A), jnp.asarray(X0), tol=1e-9)
    assert len(steps) == len(list(jt))
    r = pits.lobpcg(to_torch(A), to_torch(X0), tol=1e-9)
    assert len(steps) == r.iterations
    torch.testing.assert_close(it.state.lam, r.lam, rtol=1e-14, atol=0)
    torch.testing.assert_close(it.x, r.X, rtol=1e-12, atol=1e-12)
    assert float(steps[-1]) <= 1e-9


def indefinite_start(n):
    """B = diag(1, ..., 1, -1, ..., -1) and a start block whose vectors
    have positive B-norms but whose B-Gram is indefinite: the Cholesky
    factor of the first CholQR does not exist."""
    B = np.diag(np.r_[np.ones(n // 2), -np.ones(n - n // 2)])
    X0 = np.zeros((n, 2))
    X0[0] = 1.0
    X0[n // 2, 0] = X0[n // 2 + 1, 1] = 0.9
    return B, X0


def test_lobpcg_gram_not_positive_definite_returns_as_jax(rng):
    """jnp.linalg.cholesky gives NaNs for the indefinite Gram, and so does
    the port's cholesky_ex route, with no exception; the NaNs flow on as in
    the JAX package: the same eigenvalue placeholders (no Ritz pair is
    alive), NaN vectors and residuals, not converged, after the same
    steps."""
    jits, jnp, _ = _jax()
    n = 40
    A = _spectrum_matrix(rng, n, F64)
    B, X0 = indefinite_start(n)
    rj = jits.lobpcg(jnp.asarray(A), jnp.asarray(X0), B=jnp.asarray(B),
                     maxiter=20)
    rp = pits.lobpcg(to_torch(A), to_torch(X0), B=to_torch(B), maxiter=20)
    np.testing.assert_array_equal(to_numpy(rp.lam), np.asarray(rj.lam))
    assert np.isnan(np.asarray(rj.X)).all() and torch.isnan(rp.X).all()
    np.testing.assert_array_equal(to_numpy(rp.residual_norms),
                                  np.asarray(rj.residual_norms))
    assert (rp.converged, rp.iterations) == (rj.converged, rj.iterations)
    assert not rp.converged
    R = plob._chol_factor(to_torch(X0.T), to_torch(-X0.T))
    assert torch.isnan(R).all()


def test_lobpcg_guards_and_exact_start(rng):
    """The blocksize guard, the default tolerance, and an exact eigenvector
    start converging in at most 2 iterations (test/lobpcg.jl:46-48)."""
    jits, jnp, _ = _jax()
    with pytest.raises(ValueError, match="3 \\* blocksize"):
        pits.lobpcg(torch.eye(8, dtype=torch.float64),
                    torch.ones(8, 3, dtype=torch.float64))
    assert pits.lobpcg.__module__.endswith("lobpcg")
    assert plob.default_tolerance(torch.float64) == \
        float(np.finfo(np.float64).eps ** 0.3)
    A = _spectrum_matrix(rng, 40, F64)
    _, V = np.linalg.eigh(A)
    rj = jits.lobpcg(jnp.asarray(A), jnp.asarray(V[:, :3]), tol=1e-8)
    rp = pits.lobpcg(to_torch(A), to_torch(V[:, :3]), tol=1e-8)
    assert rp.converged and rp.iterations == rj.iterations <= 2


# ---- svdl --------------------------------------------------------------------

def _svdl_operator(spec, backend):
    """The case's operator: a dense matrix from its seed, or a
    GradientOperator, in the JAX package ("jax") or the port ("torch")."""
    if spec["kind"] == "gradient":
        if backend == "jax":
            import iterativesolvers_tpu as jits
            return jits.GradientOperator(tuple(spec["dims"]), dtype=F64)
        return convert.operator_from_arrays(
            {"kind": "gradient", "dims": tuple(spec["dims"]),
             "dtype": "float64"}, device=CPU)
    A = _svdl_matrix(spec)
    if backend == "jax":
        import jax.numpy as jnp
        return jnp.asarray(A)
    return to_torch(A)


def _svdl_matrix(spec):
    r = np.random.default_rng(spec["seed"])
    m, n = spec["shape"]
    dtype = np.dtype(spec["dtype"])
    A = _randn(r, (m, n), dtype)
    if "rank" in spec:
        # rank-deficient: the projected B becomes singular
        U, s, Vh = np.linalg.svd(A, full_matrices=False)
        s[spec["rank"]:] = 0
        A = ((U * s) @ Vh).astype(dtype)
    return A


def _svdl_v0(spec, n):
    return _randn(np.random.default_rng(spec["seed"] + 1), (n,),
                  np.dtype(spec.get("dtype", "float64")))


SVDL = {  # name: (operator spec, keywords)
    "ritz": ({"kind": "dense", "shape": [70, 45], "dtype": "float64",
              "seed": 1}, dict(nsv=3, tol=1e-10)),
    "harmonic": ({"kind": "dense", "shape": [70, 45], "dtype": "float64",
                  "seed": 1}, dict(nsv=3, tol=1e-10, method="harmonic")),
    "ritz dolock": ({"kind": "dense", "shape": [70, 45], "dtype": "float64",
                     "seed": 1}, dict(nsv=3, tol=1e-10, dolock=True)),
    "complex ritz": ({"kind": "dense", "shape": [70, 45],
                      "dtype": "complex128", "seed": 2},
                     dict(nsv=3, tol=1e-10)),
    "f32 ritz": ({"kind": "dense", "shape": [70, 45], "dtype": "float32",
                  "seed": 3}, dict(nsv=3)),
    "singular B, harmonic": ({"kind": "dense", "shape": [70, 45],
                              "dtype": "float64", "seed": 4, "rank": 4},
                             dict(nsv=3, tol=1e-12, method="harmonic")),
    "gradient": ({"kind": "gradient", "dims": [6, 6, 6], "seed": 5},
                 dict(nsv=3, tol=1e-8)),
}


def _jax_svdl_references(inp, out):
    """Script mode: the JAX package's svdl of every SVDL case (log and
    vecs='both'), written to ``out`` as .npz."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import iterativesolvers_tpu as jits

    cases = json.loads(open(inp).read())
    res = {}
    for name, (spec, kw) in cases.items():
        A = _svdl_operator(spec, "jax")
        v0 = jnp.asarray(_svdl_v0(spec, A.shape[1]))
        (U, s, Vt), L, h = jits.svdl(A, v0=v0, vecs="both", log=True, **kw)
        vals = {"s": s, "U": U, "Vt": Vt, "iters": h.iters,
                "converged": h.isconverged, "mvps": h.mvps,
                "mtvps": h.mtvps, "beta": L.beta, "ritz": h["ritz"],
                "resnorm": h["resnorm"], "betas": h["betas"],
                "conv": h["conv"], "Bs": h["Bs"]}
        for key, v in vals.items():
            res[f"{name}/{key}"] = np.asarray(v)
    np.savez(out, **res)


@pytest.fixture(scope="module", autouse=True)
def _svdl_process(tmp_path_factory):
    """The fresh interpreter that makes the JAX package's svdl references,
    started with the module's first test so that it runs beside the LOBPCG
    tests; returns (process, output file)."""
    tmp = tmp_path_factory.mktemp("svdl")
    inp, out = tmp / "cases.json", tmp / "refs.npz"
    inp.write_text(json.dumps(SVDL))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.path.dirname(os.path.abspath(__file__))]))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             str(inp), str(out)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=env, cwd=root)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_svdl(_svdl_process):
    """The JAX package's svdl references, case by case."""
    proc, out = _svdl_process
    log = proc.communicate(timeout=300)[0].decode()
    assert proc.returncode == 0, log[-4000:]
    refs = dict(np.load(out))
    return lambda name: {k.split("/", 1)[1]: v for k, v in refs.items()
                         if k.startswith(name + "/")}


@pytest.mark.parametrize("name", list(SVDL))
def test_svdl_matches_jax(jax_svdl, name):
    """Ritz and harmonic restarts, locking, complex, f32, a rank-deficient
    matrix whose projected B is singular (the harmonic restart's minimum-
    norm solve), and the GradientOperator: the values, both vector panels
    (up to each vector's phase), the iteration and product counts and the
    history."""
    spec, kw = SVDL[name]
    ref = jax_svdl(name)
    A = _svdl_operator(spec, "torch")
    v0 = to_torch(_svdl_v0(spec, A.shape[1]))
    (U, s, Vt), L, h = pits.svdl(A, v0=v0, vecs="both", log=True, **kw)
    l = kw["nsv"]
    assert s.shape == (l,) and U.shape == (A.shape[0], l)
    assert Vt.shape == (l, A.shape[1])
    assert isinstance(L, pits.solvers.svdl.PartialFactorization)
    assert torch.isfinite(s).all() and bool(h.isconverged) == \
        bool(ref["converged"])
    if spec.get("dtype") == "float32":
        assert abs(h.iters - int(ref["iters"])) <= 2
        assert rel(to_numpy(s), ref["s"]) <= 1e-4
        return
    assert (h.iters, h.mvps, h.mtvps) == (int(ref["iters"]),
                                          int(ref["mvps"]),
                                          int(ref["mtvps"]))
    assert rel(to_numpy(s), ref["s"]) <= 1e-10
    for key in ("ritz", "betas", "conv", "Bs"):
        assert h[key].shape == ref[key].shape, key
    np.testing.assert_array_equal(h["conv"], ref["conv"])
    np.testing.assert_allclose(h["ritz"], ref["ritz"], rtol=1e-10,
                               atol=1e-12 * ref["ritz"].max())
    # betas fall to rounding level where A's rank is below k
    np.testing.assert_allclose(h["betas"], ref["betas"], rtol=1e-10,
                               atol=1e-12 * ref["ritz"].max())
    # per-vector phase: |<u_p, u_j>| = 1
    for got, want in ((to_numpy(U), ref["U"]), (to_numpy(Vt).T,
                                                  ref["Vt"].T)):
        d = np.abs(np.sum(got.conj() * want, axis=0))
        np.testing.assert_allclose(d, 1.0, atol=1e-9)
    if "rank" in spec:
        np.testing.assert_allclose(to_numpy(s), np.linalg.svd(
            _svdl_matrix(spec), compute_uv=False)[:l], rtol=1e-10)


def test_svdl_iterator_and_guards(jax_svdl):
    """Stepping svdl_iterator reaches the one-shot solve's values in as
    many steps as the JAX package's solve; harmonic on a complex operator
    and a bad k raise as in the JAX package."""
    spec, kw = SVDL["ritz"]
    ref = jax_svdl("ritz")
    A = _svdl_operator(spec, "torch")
    v0 = to_torch(_svdl_v0(spec, A.shape[1]))
    it = pits.svdl_iterator(A, v0=v0, **kw)
    bounds = [float(b) for b in it]
    assert len(bounds) == int(ref["iters"])
    assert rel(to_numpy(it.x), ref["s"]) <= 1e-10
    np.testing.assert_allclose(bounds, ref["resnorm"][:, :3].max(axis=1),
                               rtol=1e-8, atol=1e-14)
    Ac = _svdl_operator(SVDL["complex ritz"][0], "torch")
    with pytest.raises(ValueError, match="real operators only"):
        pits.svdl(Ac, nsv=3, method="harmonic")
    with pytest.raises(ValueError, match="k must be"):
        pits.svdl(A, nsv=3, k=1)
    with pytest.raises(ValueError, match="unknown restart"):
        pits.svdl(A, method="thick")


def test_svdl_default_start_is_the_generator(jax_svdl):
    """With no v0 the start is a normal draw of ``key`` (a torch.Generator;
    seeded 0 on the operator's device when None): the same key gives the
    same answer, and from its own start the port finds the values the JAX
    package finds from its start: each within its own error bound (the
    last logged bound) of numpy's SVD."""
    spec, kw = SVDL["ritz"]
    A = _svdl_operator(spec, "torch")
    s1, _, h = pits.svdl(A, log=True, **kw)
    s2, _ = pits.svdl(A, key=torch.Generator().manual_seed(0), **kw)
    assert torch.equal(s1, s2) and h.isconverged
    exact = np.linalg.svd(_svdl_matrix(spec), compute_uv=False)[:3]
    ref = jax_svdl("ritz")
    for got, bound in ((to_numpy(s1), h["resnorm"][-1, :3]),
                       (ref["s"], ref["resnorm"][-1, :3])):
        assert (np.abs(got - exact) <= bound + 1e-12).all()


if __name__ == "__main__":
    _jax_svdl_references(*sys.argv[1:3])
