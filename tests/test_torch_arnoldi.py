"""The port's GMRES ops against the JAX package's: the panel kernels'
plain versions (``ops/cuda_mgs.py``, ``ops/cuda_arnoldi.py``) against the
Pallas kernels they replace, run in interpret mode at the shapes and
tolerances of ``tests/test_pallas.py``, and the small ops (``ops/givens.py``,
``ops/hessenberg.py``, ``ops/orthogonalize.py``, ``safe_inv``) against the
JAX functions in f64 at rtol 1e-12.

The JAX kernels take a panel padded to (rows, 512) rows; their outputs are
unpadded before the comparison.  The CUDA kernels themselves are held
against the plain versions on a card by ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterativesolvers_tpu as jits
from iterativesolvers_tpu.ops import givens as jgivens
from iterativesolvers_tpu.ops import hessenberg as jhess
from iterativesolvers_tpu.ops import orthogonalize as jorth
from iterativesolvers_tpu.ops.pallas_arnoldi import (
    fused_arnoldi, fused_arnoldi_plan, stencil_panel_mv)
from iterativesolvers_tpu.ops.pallas_mgs import mgs_pad, panel_mgs
from iterativesolvers_tpu.solvers import common as jcommon

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.ops import cuda_arnoldi, cuda_mgs
from iterativesolvers_tpu_torch.ops import givens as pgivens
from iterativesolvers_tpu_torch.ops import hessenberg as phess
from iterativesolvers_tpu_torch.ops import orthogonalize as porth
from iterativesolvers_tpu_torch.solvers import common as pcommon

from _torch_port import port_stencil, to_numpy, to_torch

torch.set_num_threads(1)

PANEL = {"f32": (np.float32, torch.float32, jnp.float32),
         "bf16": (None, torch.bfloat16, jnp.bfloat16)}


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


def _orthonormal_panel(n, m1, k, seed):
    """(m1, n_pad) f32 panel with orthonormal rows 0..k (numpy QR) and
    zeros elsewhere, as tests/test_pallas.py builds it."""
    r = np.random.default_rng(seed)
    V = np.zeros((m1, mgs_pad(n)), np.float32)
    Q, _ = np.linalg.qr(r.standard_normal((n, k + 1)).astype(np.float32))
    V[: k + 1, :n] = Q.T
    return V, r


# ---------------- panel MGS (ops/pallas_mgs.py) ----------------------------


@pytest.mark.parametrize("panel", ["f32", "bf16"])
@pytest.mark.parametrize("k", [0, 3])
def test_panel_mgs_plain_matches_pallas(k, panel):
    """Ragged n (not a multiple of 512 or of the 256K chunk).  The port's
    step (do = 1) writes the normalised w as row k + 1; the Pallas function
    returns it as an f32 y.  Each version is held to the bounds
    tests/test_pallas.py sets the Pallas kernel against an f64 MGS of the
    same rows: h within 2e-5 (f32 panel) or 1e-4 (bf16), nrm within 1e-5
    relative; so nrm within 2e-5 of each other (the f32 sums of 1M squares
    round differently: the TPU kernel in 512 lanes, torch pairwise).  The
    f32 row within 2e-4 / 2e-5 of y; a bf16 row within one bf16 step (2^-7
    relative) of y rounded to bf16, since the f32 values it rounds differ in
    the last bits."""
    n, m1 = 4 * 262144 + 3000, 6
    V, r = _orthonormal_panel(n, m1, k, seed=k)
    w = r.standard_normal(n).astype(np.float32)
    Vj = jnp.asarray(V.reshape(-1)).astype(PANEL[panel][2])
    y, h, nrm = panel_mgs(Vj, jnp.asarray(w), jnp.int32(k), m1,
                          interpret=True)
    Vf = np.asarray(Vj.reshape(m1, -1)[:, :n]).astype(np.float32)
    Vp = to_torch(Vf).to(PANEL[panel][1])
    hp, nrmp = cuda_mgs.panel_mgs(Vp, to_torch(w), _i32(k), _i32(1))
    wr = w.astype(np.float64)
    href = np.zeros(m1)
    for j in range(k + 1):
        href[j] = Vf[j].astype(np.float64) @ wr
        wr -= href[j] * Vf[j]
    nref = np.linalg.norm(wr)
    tol = 2e-5 if panel == "f32" else 1e-4
    for hh, nn in ((to_numpy(hp), float(nrmp)), (np.asarray(h), float(nrm))):
        np.testing.assert_allclose(hh, href, rtol=tol, atol=tol)
        assert abs(nn - nref) <= 1e-5 * nref
    np.testing.assert_allclose(to_numpy(hp), np.asarray(h), rtol=tol, atol=tol)
    assert abs(float(nrmp) - float(nrm)) <= 2e-5 * float(nrm)
    y = np.asarray(y).reshape(-1)[:n]
    row = Vp[k + 1].float().numpy()
    if panel == "f32":
        np.testing.assert_allclose(row, y, rtol=2e-4, atol=2e-5)
    else:
        yb = to_torch(y).to(torch.bfloat16).float().numpy()
        np.testing.assert_allclose(row, yb, rtol=2 ** -7, atol=2e-5)
    assert np.all(to_numpy(hp)[k + 1:] == 0)
    assert torch.equal(Vp[: k + 1], to_torch(Vf[: k + 1]).to(Vp.dtype))
    assert not Vp[k + 2:].any()


def test_panel_mgs_step_writes_row_k_plus_1_masked_by_do(rng):
    """GMRES's form: row k+1 = the normalised w times do, in the panel's
    dtype, with w = sum_j h_j V_j + nrm V[k+1]; rows 0..k untouched; do = 0
    writes zeros and returns the same h and nrm."""
    n, m1, k = 300, 5, 2
    V, r = _orthonormal_panel(n, m1, k, seed=4)
    w = to_torch(r.standard_normal(n).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        Vt = to_torch(V[:, :n]).to(dt)
        before = Vt.clone()
        h1, nrm1 = cuda_mgs.panel_mgs(Vt, w, _i32(k), _i32(1))
        assert torch.equal(Vt[: k + 1], before[: k + 1])
        assert torch.equal(Vt[k + 2:], before[k + 2:])
        Vd = Vt.double()
        back = h1.double() @ Vd[: m1] + nrm1.double() * Vd[k + 1]
        tol = 1e-6 if dt == torch.float32 else 2 ** -7
        assert float((back - w.double()).abs().max()) <= tol * float(
            w.abs().max())
        h0, nrm0 = cuda_mgs.panel_mgs(Vt, w, _i32(k), _i32(0))
        assert torch.equal(h0, h1) and torch.equal(nrm0, nrm1)
        assert not Vt[k + 1].any()


def test_panel_mgs_skips_rows_past_k():
    """Rows past k are never read: NaN there (row k + 1 included, which the
    step overwrites) changes nothing."""
    n, m1, k = 200, 4, 1
    V, r = _orthonormal_panel(n, m1, k, seed=5)
    w = to_torch(r.standard_normal(n).astype(np.float32))
    Vt = to_torch(V[:, :n])
    h, nrm = cuda_mgs.panel_mgs(Vt, w, _i32(k), _i32(1))
    Vn = Vt.clone()
    Vn[k + 1:] = float("nan")
    h2, nrm2 = cuda_mgs.panel_mgs(Vn, w, _i32(k), _i32(1))
    assert torch.equal(h, h2) and torch.equal(nrm, nrm2)
    assert torch.equal(Vt[: k + 2], Vn[: k + 2])


def test_panel_mgs_plain_shares_the_orthogonalize_sweep():
    """The plain version's sweep is ``ops/orthogonalize.py``'s MGS masked at
    k: with every row active it gives the unmasked h bit for bit."""
    g = torch.Generator().manual_seed(6)
    V = torch.randn(4, 50, generator=g)
    w = torch.randn(50, generator=g)
    ym, hm = porth.mgs_rows(V, w, torch.tensor(3))
    yu, hu = porth.mgs_rows(V, w)
    assert torch.equal(ym, yu) and torch.equal(hm, hu)
    Vp = torch.cat([V, torch.zeros(1, 50)])
    h, _ = cuda_mgs.panel_mgs(Vp, w, _i32(3), _i32(1))
    assert torch.equal(h[:4], hu)


def test_panel_mgs_wrapper_on_cpu_checks_and_counts_no_launch():
    V = torch.zeros(3, 16)
    V[0, 0] = 1.0
    w = torch.arange(16.0)
    before = cuda_mgs.panel_mgs.launches
    Vp = V.clone()
    got = cuda_mgs.panel_mgs(V, w, _i32(0), _i32(1))
    want = cuda_mgs.panel_mgs_plain(Vp, w, _i32(0), _i32(1))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(V, Vp)
    assert cuda_mgs.panel_mgs.launches == before
    with pytest.raises(ValueError, match="f32 or bf16 panel"):
        cuda_mgs.panel_mgs(V.double(), w, _i32(0), _i32(1))
    with pytest.raises(ValueError, match="w must be"):
        cuda_mgs.panel_mgs(V, w[:15], _i32(0), _i32(1))
    with pytest.raises(ValueError, match="0-d int32"):
        cuda_mgs.panel_mgs(V, w, 0, _i32(1))
    with pytest.raises(ValueError, match="0-d int32"):
        cuda_mgs.panel_mgs(V, w, _i32(0), torch.tensor(True))
    with pytest.raises(ValueError, match="m1 >= 2"):
        cuda_mgs.panel_mgs(V[:1], w, _i32(0), _i32(1))


# ---------------- stencil_panel_mv / fused_arnoldi (ops/pallas_arnoldi.py) --


def _stencil_problem(panel, k, m1, seed, orthonormal):
    St = jits.laplacian(1024, 2, dtype=np.float32)  # n = 1,048,576
    n = St.n
    pd = PANEL[panel][2]
    plan = fused_arnoldi_plan(n, St.terms, jnp.float32, pd)
    assert plan is not None
    if orthonormal:
        V, _ = _orthonormal_panel(n, m1, k, seed)
    else:
        V = np.zeros((m1, mgs_pad(n)), np.float32)
        V[: k + 1, :n] = np.random.default_rng(seed).standard_normal(
            (k + 1, n)).astype(np.float32)
    Vj = jnp.asarray(V.reshape(m1, -1, 512)).astype(pd)
    Vp = to_torch(np.asarray(Vj.reshape(m1, -1)[:, :n]).astype(np.float32))
    return St, plan, Vj, Vp.to(PANEL[panel][1]), n


def _jax_coeffs(St, plan):
    return ([St.coeffs[i] for i in plan.inner_idx],
            [St.coeffs[i] for i in plan.outer_idx])


@pytest.mark.parametrize("panel", ["f32", "bf16"])
def test_stencil_panel_mv_plain_matches_pallas(panel):
    """w = A V[k] from either panel dtype, f32 out, within 1e-5 of max|w|
    (tests/test_pallas.py): the TPU kernel adds the center first, the port
    in ascending offset order."""
    m1, k = 4, 2
    St, plan, Vj, Vp, n = _stencil_problem(panel, k, m1, 3, False)
    w = stencil_panel_mv(plan, Vj, jnp.int32(k), St.center,
                         *_jax_coeffs(St, plan), m1, interpret=True)
    P = port_stencil(St)
    wp = cuda_arnoldi.stencil_panel_mv(P.n, P.center, P.terms, P.coeffs, Vp,
                                       _i32(k))
    assert wp.dtype == torch.float32 and wp.shape == (n,)
    w = np.asarray(w).reshape(-1)
    np.testing.assert_allclose(to_numpy(wp), w[:n], rtol=1e-5,
                               atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("panel,do", [("f32", 1), ("f32", 0), ("bf16", 1)])
def test_fused_arnoldi_plain_matches_pallas(panel, do):
    """One fused step: h within 3e-4 and nrm within 3e-4 relative, row k+1
    within 2e-3 / 2e-4 (tests/test_pallas.py; a bf16 row may differ by one
    bf16 step, up to 2^-7 relative); rows 0..k bit-unchanged, rows past k+1
    zero, and with do = 0 row k+1 zero too."""
    m1, k = 5, 2
    St, plan, Vj, Vp, n = _stencil_problem(panel, k, m1, 7, True)
    Vo, h, nrm = fused_arnoldi(plan, Vj, jnp.int32(k), jnp.int32(do),
                               St.center, *_jax_coeffs(St, plan), m1,
                               interpret=True)
    P = port_stencil(St)
    before = Vp.clone()
    hp, nrmp = cuda_arnoldi.fused_arnoldi(P.n, P.center, P.terms, P.coeffs,
                                          Vp, _i32(k), _i32(do))
    h, nrm = np.asarray(h), float(nrm)
    np.testing.assert_allclose(to_numpy(hp), h, rtol=3e-4,
                               atol=3e-4 * max(1.0, np.abs(h).max()))
    assert abs(float(nrmp) - nrm) <= 3e-4 * nrm
    assert torch.equal(Vp[: k + 1], before[: k + 1])
    assert not Vp[k + 2:].any()
    row = np.asarray(Vo.reshape(m1, -1)[k + 1, :n]).astype(np.float32)
    if do:
        tol = 2e-3 if panel == "f32" else 2 ** -7
        np.testing.assert_allclose(to_numpy(Vp[k + 1]), row, rtol=tol,
                                   atol=2e-4)
    else:
        assert not Vp[k + 1].any() and not row.any()


@pytest.mark.parametrize("panel", ["f32", "bf16"])
def test_fused_plain_equals_panel_mv_then_panel_mgs_bitwise(panel):
    """The fused step's plain version is the two-kernel route's plain
    versions, bit for bit, do = 1 and 0."""
    P = pits.advection_diffusion_stencil(9, device="cpu")
    m1, k = 6, 3
    V, _ = _orthonormal_panel(P.n, m1, k, seed=2)
    for do in (1, 0):
        Va = to_torch(V[:, :P.n]).to(PANEL[panel][1])
        Vb = Va.clone()
        args = (P.n, P.center, P.terms, P.coeffs)
        h1, n1 = cuda_arnoldi.fused_arnoldi(*args, Va, _i32(k), _i32(do))
        w = cuda_arnoldi.stencil_panel_mv(*args, Vb, _i32(k))
        h2, n2 = cuda_mgs.panel_mgs(Vb, w, _i32(k), _i32(do))
        assert torch.equal(h1, h2) and torch.equal(n1, n2)
        assert torch.equal(Va, Vb)


def test_stencil_panel_mv_equals_operator_on_the_row():
    """The panel SpMV of row k is the operator's product of that row in f32
    (the same sum order as the stencil kernel), bit for bit."""
    P = pits.laplacian(10, 3, device="cpu")
    V = torch.randn(3, P.n, generator=torch.Generator().manual_seed(0))
    for dt in (torch.float32, torch.bfloat16):
        Vd = V.to(dt)
        w = cuda_arnoldi.stencil_panel_mv(P.n, P.center, P.terms, P.coeffs,
                                          Vd, _i32(1))
        assert torch.equal(w, P.mv(Vd[1].float()))


def test_arnoldi_wrappers_on_cpu_check_and_count_no_launch():
    P = pits.laplacian(4, 2, device="cpu")
    V = torch.zeros(3, P.n)
    V[0, 0] = 1.0
    args = (P.n, P.center, P.terms, P.coeffs)
    before = (cuda_arnoldi.stencil_panel_mv.launches,
              cuda_arnoldi.fused_arnoldi.launches)
    cuda_arnoldi.stencil_panel_mv(*args, V, _i32(0))
    cuda_arnoldi.fused_arnoldi(*args, V, _i32(0), _i32(1))
    assert (cuda_arnoldi.stencil_panel_mv.launches,
            cuda_arnoldi.fused_arnoldi.launches) == before
    with pytest.raises(ValueError, match="panel"):
        cuda_arnoldi.stencil_panel_mv(*args, torch.zeros(3, P.n - 1), _i32(0))
    with pytest.raises(ValueError, match="0-d int32"):
        cuda_arnoldi.fused_arnoldi(*args, V, _i32(0), 1)


# ---------------- small ops against the JAX package, f64 ------------------


def _c(v):
    return complex(np.asarray(v))


@pytest.mark.parametrize("cplx", [False, True])
def test_givens_matches_jax(rng, cplx):
    vals = [0.0, 1.5, -2.0]
    if cplx:
        vals += [1 - 2j, -0.5j]
    else:
        vals += [3e-200, -7.25]
    for a in vals:
        for b in vals:
            dt = np.complex128 if cplx else np.float64
            want = jgivens.givens(jnp.asarray(a, dt), jnp.asarray(b, dt))
            got = pgivens.givens(torch.tensor(a, dtype=to_torch(
                np.zeros(1, dt)).dtype), torch.tensor(b, dtype=to_torch(
                    np.zeros(1, dt)).dtype))
            for g_, w_ in zip(got, want):
                np.testing.assert_allclose(_c(g_), _c(w_), rtol=1e-12,
                                           atol=1e-300)
            assert not got[0].is_complex()


def _seq_chain(cs, ss, col):
    col = col.copy()
    for j in range(len(cs)):
        x, y = col[j], col[j + 1]
        col[j], col[j + 1] = (cs[j] * x + ss[j] * y,
                              -np.conj(ss[j]) * x + cs[j] * y)
    return col


@pytest.mark.parametrize("m", [1, 7, 20])
@pytest.mark.parametrize("cplx", [False, True])
def test_apply_givens_chain_matches_loop_and_jax(rng, m, cplx):
    """The Hillis-Steele scan against the sequential rotations and JAX's
    associative_scan; rotations past k = m // 2 are identities."""
    th = rng.uniform(0, 2 * np.pi, m)
    cs = np.cos(th)
    ss = np.sin(th)
    col = rng.standard_normal(m + 1)
    if cplx:
        ss = ss * np.exp(1j * rng.uniform(0, 2 * np.pi, m))
        col = col + 1j * rng.standard_normal(m + 1)
    cs[m // 2 + 1:] = 1.0
    ss[m // 2 + 1:] = 0.0
    got = to_numpy(pgivens.apply_givens_chain(to_torch(cs), to_torch(ss),
                                              to_torch(col)))
    np.testing.assert_allclose(got, _seq_chain(cs, ss, col), rtol=1e-12,
                               atol=1e-13)
    want = jgivens.apply_givens_chain(jnp.asarray(cs), jnp.asarray(ss),
                                      jnp.asarray(col))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-13)


def _hessenberg(rng, m, k, cplx):
    H = np.triu(rng.standard_normal((m + 1, m)), -1) + 3 * np.eye(m + 1, m)
    if cplx:
        H = H + 1j * np.triu(rng.standard_normal((m + 1, m)), -1)
    H[:, k:] = 0
    rhs = rng.standard_normal(m + 1) + (1j * rng.standard_normal(m + 1)
                                        if cplx else 0)
    return H, rhs


@pytest.mark.parametrize("cplx", [False, True])
def test_back_substitute_matches_jax(rng, cplx):
    m = 8
    for k in (0, 3, m):
        H, g = _hessenberg(rng, m, k, cplx)
        R = np.triu(H[:m, :])
        want = jhess.back_substitute(jnp.asarray(R), jnp.asarray(g[:m]),
                                     jnp.int32(k))
        got = phess.back_substitute(to_torch(R), to_torch(g[:m]),
                                    torch.tensor(k))
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   rtol=1e-12, atol=1e-14)
        assert not to_numpy(got)[k:].any()


@pytest.mark.parametrize("method", ["dense", "givens", "auto"])
@pytest.mark.parametrize("cplx", [False, True])
def test_hessenberg_lstsq_matches_jax(rng, method, cplx):
    m = 6
    for k in (None, 4, 1):
        H, rhs = _hessenberg(rng, m, m if k is None else k, cplx)
        kj = None if k is None else jnp.int32(k)
        kp = None if k is None else torch.tensor(k)
        y, res = jhess.hessenberg_lstsq(jnp.asarray(H), jnp.asarray(rhs), kj,
                                        method=method)
        yp, resp = pits.hessenberg_lstsq(to_torch(H), to_torch(rhs), kp,
                                         method=method)
        np.testing.assert_allclose(to_numpy(yp), np.asarray(y), rtol=1e-12,
                                   atol=1e-13)
        np.testing.assert_allclose(float(resp), float(res), rtol=1e-12)
    with pytest.raises(ValueError, match="unknown method"):
        pits.hessenberg_lstsq(to_torch(H), to_torch(rhs), method="qr")


@pytest.mark.parametrize("method", ["mgs", "cgs", "cgs2", "dgks"])
@pytest.mark.parametrize("cplx", [False, True])
def test_orthogonalize_matches_jax(rng, method, cplx):
    """Both layouts: columns (the public function) and rows (GMRES's), with
    zero inactive vectors; the DGKS case needs a re-orthogonalization (w
    nearly in the span)."""
    n, m = 40, 5
    V = rng.standard_normal((n, m))
    if cplx:
        V = V + 1j * rng.standard_normal((n, m))
    V, _ = np.linalg.qr(V)
    V[:, 3:] = 0
    w = V @ rng.standard_normal(m) + 0.1 * rng.standard_normal(n)
    for args_j, args_p, fn in (
            ((V, w), (V, w), "orthogonalize_and_normalize"),
            ((V.T, w), (V.T.copy(), w), "orthogonalize_and_normalize_rows")):
        want = getattr(jorth, fn)(*map(jnp.asarray, args_j), method)
        got = getattr(porth, fn)(*map(to_torch, args_p), method)
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(to_numpy(g_), np.asarray(w_),
                                       rtol=1e-12, atol=1e-14)
    assert pits.ORTH_METHODS == jits.ORTH_METHODS
    with pytest.raises(ValueError, match="unknown orthogonalization"):
        pits.orthogonalize_and_normalize(to_torch(V), to_torch(w), "qr")


def test_safe_inv_matches_jax():
    x = np.array([2.0, 0.0, -1.0, 1e-300, 4.0])
    np.testing.assert_array_equal(
        to_numpy(pcommon.safe_inv(to_torch(x))),
        np.asarray(jcommon.safe_inv(jnp.asarray(x))))
