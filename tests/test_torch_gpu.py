"""The port's CUDA kernels against their plain PyTorch versions on a card.

Every test here is marked ``gpu`` and skips where torch has no CUDA.  The
file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: f32 y within 1e-6 of max|y| (FMA contraction), bf16 y within
2e-2 (8 mantissa bits, rounded at other points), dots within 1e-5 relative
(another sum order).
"""

import numpy as np
import pytest
import torch

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.ops import (cuda_arnoldi, cuda_mgs, cuda_spmv,
                                           cuda_stencil)
from iterativesolvers_tpu_torch.utils import fixtures as pfix

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built by nvcc and "
                    "run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("side", [1, 5, 67])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_stencil_matches_plain(cuda, side, dtype):
    St = pits.advection_diffusion_stencil(side, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(side)
    x = torch.randn(St.n, generator=g, device=cuda).to(dtype)
    args = (St.n, St.center, St.terms, St.coeffs)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    before = cuda_stencil.stencil_apply.launches
    for conj in (False, True):
        y, d = cuda_stencil.stencil_apply(*args, x, conj=conj, with_dot=True)
        yp, dp = cuda_stencil.stencil_apply_plain(*args, x, conj=conj,
                                                  with_dot=True)
        torch.cuda.synchronize()
        scale = float(yp.float().abs().max())
        assert float((y.float() - yp.float()).abs().max()) <= tol * scale
        assert abs(float(d) - float(dp)) <= 1e-5 * abs(float(dp)) + 1e-6
    assert cuda_stencil.stencil_apply.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_cuda_dia_matches_plain(cuda, dtype):
    A = pits.compress_values(pfix.laplace_dia(37, 3, dtype=np.float32,
                                              device=cuda), dtype)
    assert A.dtype == dtype
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(A.shape[0], generator=g, device=cuda)
    before = cuda_spmv.dia_spmv_dot.launches
    y, d = A.mv_dot(x)
    yp, dp = cuda_spmv.dia_spmv_plain(A.diags, A.offsets, x, x)
    torch.cuda.synchronize()
    assert float((y - yp).abs().max()) <= 1e-6 * float(yp.abs().max())
    assert abs(float(d) - float(dp)) <= 1e-5 * abs(float(dp))
    assert cuda_spmv.dia_spmv_dot.launches == before + 1


def _stencils(cuda):
    """Stencils at the edges of the run design: a 2-D Laplacian; n not a
    multiple of any run (4, 8 or 16 rows); offsets not multiples of 4 and
    beyond a run, and terms that share no (stride, extent) group."""
    return {
        "laplacian 2-D 67^2": pits.laplacian(67, 2, device=cuda),
        "laplacian 3-D 16^3 (n a multiple of every run)": pits.laplacian(
            16, 3, device=cuda),
        "general n=1003": pits.StencilOperator(
            1003, 4.5, ((3, 1, 17), (-5, 1, 17), (34, 17, 59), (-35, 17, 59),
                        (1, 1, 1003), (-2, 1, 1003), (118, 1, 1003)),
            (-1.25, 0.5, -0.75, 2.0, -1.0, 0.25, 3.0), device=cuda),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["laplacian 2-D 67^2",
                                  "laplacian 3-D 16^3 (n a multiple of every "
                                  "run)", "general n=1003"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 1])
def test_cuda_stencil_edges_match_plain(cuda, name, dtype, shift):
    """stencil_apply with and without the dot, A and A^T, against its plain
    version; shift = 1 hands the kernel an x that starts one element past a
    16-byte boundary (a view), which it takes with its per-row loads; the
    dot twice on the same inputs gives the same bits."""
    St = _stencils(cuda)[name]
    g = torch.Generator(device=cuda).manual_seed(7)
    buf = torch.randn(St.n + shift, generator=g, device=cuda).to(dtype)
    x = buf[shift:]
    assert (x.data_ptr() % 16 == 0) == (shift == 0)
    args = (St.n, St.center, St.terms, St.coeffs)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    for conj in (False, True):
        yp, dp = cuda_stencil.stencil_apply_plain(*args, x, conj=conj,
                                                  with_dot=True)
        scale = float(yp.float().abs().max())
        y = cuda_stencil.stencil_apply(*args, x, conj=conj)
        y1, d1 = cuda_stencil.stencil_apply(*args, x, conj=conj,
                                            with_dot=True)
        y2, d2 = cuda_stencil.stencil_apply(*args, x, conj=conj,
                                            with_dot=True)
        torch.cuda.synchronize()
        assert float((y.float() - yp.float()).abs().max()) <= tol * scale
        assert torch.equal(y, y1) and torch.equal(y1, y2)
        assert abs(float(d1) - float(dp)) <= 1e-5 * abs(float(dp)) + 1e-6
        assert torch.equal(d1, d2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("n", [4096, 1000, 997])
@pytest.mark.parametrize("offsets", [(-131, -7, -3, 0, 2, 5, 13, 64),
                                     (-300, -131, -7, -3, -1, 0, 1, 2, 5, 13,
                                      64)])
def test_cuda_dia_edges_match_plain(cuda, dtype, n, offsets):
    """dia_spmv and dia_spmv_dot on offsets that are not multiples of 4 and
    reach past a run, n a multiple of 16 or not, 8 diagonals or more than 8;
    u = x and u != x; a diagonal view one element past a 16-byte boundary; the dot
    twice on the same inputs gives the same bits."""
    rng = np.random.default_rng(n)
    vals = rng.integers(-9, 10, (len(offsets), n + 1)).astype(np.float32)
    buf = [torch.from_numpy(v).to(cuda).to(dtype) for v in vals]
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, generator=g, device=cuda)
    u = torch.randn(n, generator=g, device=cuda)
    for shift in (0, 1):
        diags = [b[shift:shift + n] for b in buf]
        assert (diags[0].data_ptr() % 16 == 0) == (shift == 0)
        yp, dp = cuda_spmv.dia_spmv_plain(diags, offsets, x, x)
        _, dup = cuda_spmv.dia_spmv_plain(diags, offsets, x, u)
        y = cuda_spmv.dia_spmv(diags, offsets, x)
        y1, d1 = cuda_spmv.dia_spmv_dot(diags, offsets, x, x)
        y2, d2 = cuda_spmv.dia_spmv_dot(diags, offsets, x, x)
        yu, du = cuda_spmv.dia_spmv_dot(diags, offsets, x, u)
        torch.cuda.synchronize()
        assert float((y - yp).abs().max()) <= 1e-6 * float(yp.abs().max())
        assert torch.equal(y, y1) and torch.equal(y1, y2) and torch.equal(y, yu)
        assert abs(float(d1) - float(dp)) <= 1e-5 * abs(float(dp))
        assert abs(float(du) - float(dup)) <= 1e-5 * float(
            (u * yp).abs().sum())
        assert torch.equal(d1, d2)


@pytest.mark.gpu
def test_cuda_stencil_and_dia_give_the_same_bits(cuda):
    """On laplace_dia(67, 3) f32 stencil_apply's y equals dia_spmv's y on
    f32, bf16 and int8 diagonals bit for bit: both add the products in
    ascending offset order from 0 with one FMA each."""
    St = pits.laplacian(67, 3, device=cuda)
    A = pfix.laplace_dia(67, 3, dtype=np.float32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(St.n, generator=g, device=cuda)
    y = St.mv(x)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        Ad = pits.compress_values(A, dtype)
        assert Ad.dtype == dtype
        assert torch.equal(y, Ad.mv(x)), dtype
        assert torch.equal(y, Ad.mv_dot(x)[0]), dtype


@pytest.mark.gpu
def test_cuda_dots_on_two_streams_at_once(cuda):
    """mv_dot of the stencil and of an int8 DIA matrix enqueued on two
    streams behind a sleep kernel each, so that the launches of the two
    streams run at once: each stream's launches draw on a ticket and
    partials of their own, and every y and dot equals the one launch on the
    default stream, bit for bit."""
    St = pits.laplacian(67, 3, device=cuda)
    A = pits.compress_values(pfix.laplace_dia(67, 3, dtype=np.float32,
                                              device=cuda), torch.int8)
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(St.n, generator=g, device=cuda)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for op in (St, A):
        want_y, want_d = op.mv_dot(x)
        torch.cuda.synchronize()
        outs = ([], [])
        for s in streams:
            with torch.cuda.stream(s):
                torch.cuda._sleep(20_000_000)
        for _ in range(10):
            for s, out in zip(streams, outs):
                with torch.cuda.stream(s):
                    out.append(op.mv_dot(x))
        torch.cuda.synchronize()
        for out in outs:
            for y, d in out:
                assert torch.equal(y, want_y) and torch.equal(d, want_d)


@pytest.mark.gpu
def test_cuda_operators_past_the_kernel_limits_raise(cuda):
    """An operator sends a 1-D f32 CUDA x to its kernel whatever its size;
    past the kernel's limits the wrapper raises, never a quiet plain run.
    (The DIA kernel takes any number of diagonals, in groups: see
    test_cuda_dia_past_one_launch_of_diagonals.)"""
    St = pits.laplacian(3, 5, device=cuda)           # 10 terms
    assert len(St.terms) > cuda_stencil.MAX_TERMS
    with pytest.raises(ValueError, match="at most"):
        St.mv_dot(torch.ones(St.n, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("nd", [cuda_spmv.MAX_DIAGS + 1, 27, 40])
def test_cuda_dia_past_one_launch_of_diagonals(cuda, nd):
    """A DIA matrix of more than MAX_DIAGS diagonals launches the kernel
    once a group of MAX_DIAGS (each launch counted): y, the dot and each
    row of a panel agree with the plain version within 1e-6 of max|y|
    (f32, FMA against separate rounding) and the dot within 1e-5 of |dot|
    (another order of the sum)."""
    n = 4099                        # odd: the rows past the last whole run
    rng = np.random.default_rng(nd)
    offsets = tuple(sorted(rng.choice(np.arange(-60, 61), nd, replace=False)
                           .tolist()))
    diags = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
             for _ in offsets]
    A = pits.DIAMatrix([d.to(cuda) for d in diags], offsets, (n, n),
                       device=cuda)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    groups = -(-nd // cuda_spmv.MAX_DIAGS)
    before = (cuda_spmv.dia_spmv.launches, cuda_spmv.dia_spmv_dot.launches)
    y = A.mv(x.to(cuda))
    y2, d = A.mv_dot(x.to(cuda))
    Y = A.mv_rows(torch.stack([x, 2 * x]).to(cuda))
    torch.cuda.synchronize()
    assert (cuda_spmv.dia_spmv.launches - before[0],
            cuda_spmv.dia_spmv_dot.launches - before[1]) == (3 * groups,
                                                             groups)
    yp, dp = cuda_spmv.dia_spmv_plain(diags, offsets, x, x)
    assert torch.equal(y, y2) and torch.equal(Y[0], y)
    assert _close(y.cpu(), yp, 1e-6) and _close(Y[1].cpu(), 2 * yp, 1e-6)
    assert abs(float(d) - float(dp)) <= 1e-5 * abs(float(dp))



@pytest.mark.gpu
def test_cuda_auto_format_of_27_point_coo_runs_the_dia_kernel(cuda):
    """A 27-point stencil's COO picks DIA (27 diagonals, unpermuted), whose
    product takes the DIA kernel in two launches; CG through it launches
    dia_spmv_dot twice a step and agrees with CG on the CSR (eager, no
    kernel) within 1e-5 relative in x, both converged."""
    rows, cols, vals, n = pfix.stencil27_coo(12, 28.0, dtype=np.float32)
    A = pits.CSRMatrix.from_coo(rows, cols, vals, (n, n), device=cuda)
    op, perm = A.auto_format()
    assert isinstance(op, pits.DIAMatrix) and perm is None
    assert len(op.offsets) == 27
    x = torch.randn(n, generator=torch.Generator().manual_seed(2)).to(cuda)
    assert _close(op.mv(x), A.mv(x), 1e-6)
    before = cuda_spmv.dia_spmv_dot.launches
    b = torch.ones(n, device=cuda)
    xd, h = pits.cg(op, b, reltol=1e-6, log=True)
    assert h.isconverged and cuda_spmv.dia_spmv_dot.launches - before == (
        2 * pits.solvers.common.chunked_steps(h.iters))
    xc, hc = pits.cg(A, b, reltol=1e-6, log=True)
    assert hc.isconverged
    assert float(torch.linalg.vector_norm(xc - xd)
                 / torch.linalg.vector_norm(xc)) <= 1e-5


# ---- the GMRES panel kernels (csrc/panel_mgs.cu, csrc/arnoldi.cu) ----------
# Tolerances: f32 vectors within 1e-6 of max|.| (FMA contraction); h within
# 1e-5 of |w| (each h_j a dot of a unit row with w, summed in another
# order) and nrm within 1e-5 relative; a row stored in bf16 within one bf16
# step (2^-7 of its largest value), since the f32 values it rounds may
# differ in the last bits.


def _panel(cuda, n, dtype, m1=4, seed=0):
    """(m1, n) panel with orthonormal rows 0..k, k = min(2, n - 1), zeros
    past k; and a w of norm ~sqrt(n)."""
    k = min(2, n - 1)
    g = torch.Generator(device=cuda).manual_seed(seed)
    Q, _ = torch.linalg.qr(torch.randn(n, k + 1, generator=g, device=cuda))
    V = torch.zeros(m1, n, device=cuda)
    V[: k + 1] = Q.T
    w = torch.randn(n, generator=g, device=cuda)
    k_t = torch.tensor(k, dtype=torch.int32, device=cuda)
    return V.to(dtype), w, k_t


def _close(got, want, tol):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("side", [1, 5, 67])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_panel_mgs_matches_plain(cuda, side, dtype):
    before = cuda_mgs.panel_mgs.launches
    for do in (1, 0):
        V, w, k = _panel(cuda, side**3, dtype, seed=side + do)
        Vp = V.clone()
        do_t = torch.tensor(do, dtype=torch.int32, device=cuda)
        h, nrm = cuda_mgs.panel_mgs(V, w, k, do_t)
        hp, nrmp = cuda_mgs.panel_mgs_plain(Vp, w, k, do_t)
        torch.cuda.synchronize()
        kk = int(k)
        wn = float(torch.linalg.vector_norm(w))
        assert float((h - hp).abs().max()) <= 1e-5 * wn
        assert abs(float(nrm) - float(nrmp)) <= 1e-5 * float(nrmp)
        assert not h[kk + 1:].any()
        assert torch.equal(V[: kk + 1], Vp[: kk + 1])
        assert not V[kk + 2:].any()
        if do:
            assert _close(V[kk + 1], Vp[kk + 1],
                          1e-6 if dtype == torch.float32 else 2**-7)
        else:
            assert not V[kk + 1].any()
    assert cuda_mgs.panel_mgs.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("side", [1, 5, 16, 67])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_stencil_panel_mv_matches_plain(cuda, side, dtype):
    """Panel row k = 2 (k = 0 at side 1): at side 16 the row starts on a
    16-byte boundary and takes the kernel's vector loads, at odd sides
    it does not and takes its per-row loads."""
    St = pits.advection_diffusion_stencil(side, device=cuda)
    V, _, k = _panel(cuda, St.n, dtype, seed=side)
    args = (St.n, St.center, St.terms, St.coeffs)
    before = cuda_arnoldi.stencil_panel_mv.launches
    w = cuda_arnoldi.stencil_panel_mv(*args, V, k)
    wp = cuda_arnoldi.stencil_panel_mv_plain(*args, V, k)
    torch.cuda.synchronize()
    assert w.dtype == torch.float32 and _close(w, wp, 1e-6)
    assert cuda_arnoldi.stencil_panel_mv.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("side", [1, 5, 67])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_arnoldi_matches_plain(cuda, side, dtype):
    St = pits.laplacian(side, 3, device=cuda)
    args = (St.n, St.center, St.terms, St.coeffs)
    before = cuda_arnoldi.fused_arnoldi.launches
    for do in (1, 0):
        V, _, k = _panel(cuda, St.n, dtype, seed=side + do)
        Vp = V.clone()
        do_t = torch.tensor(do, dtype=torch.int32, device=cuda)
        h, nrm = cuda_arnoldi.fused_arnoldi(*args, V, k, do_t)
        hp, nrmp = cuda_arnoldi.fused_arnoldi_plain(*args, Vp, k, do_t)
        torch.cuda.synchronize()
        kk = int(k)
        w = cuda_arnoldi.stencil_panel_mv_plain(*args, Vp, k)
        assert float((h - hp).abs().max()) <= 1e-5 * float(
            torch.linalg.vector_norm(w))
        assert abs(float(nrm) - float(nrmp)) <= 1e-5 * float(nrmp)
        assert torch.equal(V[: kk + 1], Vp[: kk + 1])
        assert not V[kk + 2:].any()
        if do:
            assert _close(V[kk + 1], Vp[kk + 1],
                          1e-6 if dtype == torch.float32 else 2**-7)
        else:
            assert not V[kk + 1].any()
    assert cuda_arnoldi.fused_arnoldi.launches == before + 2


def _sweeps(St):
    """The two sweep kernels and their plain versions as f(V, w, k, do)."""
    args = (St.n, St.center, St.terms, St.coeffs)
    return {"panel_mgs": (cuda_mgs.panel_mgs, cuda_mgs.panel_mgs_plain),
            "fused_arnoldi": (
                lambda V, w, k, do: cuda_arnoldi.fused_arnoldi(*args, V, k, do),
                lambda V, w, k, do: cuda_arnoldi.fused_arnoldi_plain(
                    *args, V, k, do))}


def _small_grid(monkeypatch, grid):
    """Launch both sweep kernels on `grid` blocks."""
    monkeypatch.setattr(cuda_mgs, "_grid", lambda *a: grid)
    monkeypatch.setattr(cuda_arnoldi, "_fused_grid", lambda *a: grid)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["panel_mgs", "fused_arnoldi"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sweeps_spill_tier_matches_plain(cuda, monkeypatch, name, dtype):
    """Two blocks at side 67: each block's chunk (150,382 entries) fills its
    registers and shared memory and keeps the rest in device memory (the
    spill tier); against the plain versions at the tolerances above."""
    _small_grid(monkeypatch, 2)
    St = pits.laplacian(67, 3, device=cuda)
    itemsize = torch.empty((), dtype=dtype).element_size()
    smem = cuda_mgs._smem(cuda_mgs._DTYPE_CODE[dtype],
                          torch.cuda.current_device())
    assert cuda_mgs.plan_residency(St.n, 2, itemsize, smem).spill > 0
    kernel, plain = _sweeps(St)[name]
    for do in (1, 0):
        V, w, k = _panel(cuda, St.n, dtype, seed=do)
        Vp = V.clone()
        do_t = torch.tensor(do, dtype=torch.int32, device=cuda)
        h, nrm = kernel(V, w, k, do_t)
        hp, nrmp = plain(Vp, w, k, do_t)
        torch.cuda.synchronize()
        kk = int(k)
        wn = float(torch.linalg.vector_norm(
            w if name == "panel_mgs" else cuda_arnoldi.stencil_panel_mv_plain(
                St.n, St.center, St.terms, St.coeffs, Vp, k)))
        assert float((h - hp).abs().max()) <= 1e-5 * wn
        assert abs(float(nrm) - float(nrmp)) <= 1e-5 * float(nrmp)
        assert not h[kk + 1:].any()
        assert torch.equal(V[: kk + 1], Vp[: kk + 1])
        assert not V[kk + 2:].any()
        if do:
            assert _close(V[kk + 1], Vp[kk + 1],
                          1e-6 if dtype == torch.float32 else 2**-7)
        else:
            assert not V[kk + 1].any()


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [None, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sweeps_reproducible(cuda, monkeypatch, grid, dtype):
    """Two calls on the same inputs give the same bits of h, nrm and row
    k + 1 (grid-wide sums in a fixed order), on the card's own grid and on
    two blocks (the spill tier)."""
    if grid is not None:
        _small_grid(monkeypatch, grid)
    St = pits.laplacian(67, 3, device=cuda)
    V, w, k = _panel(cuda, St.n, dtype, m1=8, seed=3)
    one = torch.ones((), dtype=torch.int32, device=cuda)
    for name, (kernel, _) in _sweeps(St).items():
        outs = []
        for _ in range(2):
            Va = V.clone()
            h, nrm = kernel(Va, w, k, one)
            outs.append((h, nrm, Va[int(k) + 1]))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*outs)), name


# ---- the distributed CGS2 sweeps (csrc/panel_ortho.cu) ----------------------
# Tolerances: each part[j] a dot of a unit row with w summed in another
# order, within 1e-5 of |w|; y within 1e-6 of max|y| (one FMA a row against
# a multiply and a subtract); ss within 1e-5 relative.


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 3, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_panel_ortho_sweeps_match_plain(cuda, R, dtype):
    """panel_dots and panel_update on an (m1, R, 512) block at k = 0 and
    k = m (every row), rows past k zero, with a zero-padded w."""
    from iterativesolvers_tpu_torch.ops import cuda_panel_ortho as cpo

    m1, n = 5, R * 512
    g = torch.Generator(device=cuda).manual_seed(R)
    Q, _ = torch.linalg.qr(torch.randn(n, m1, generator=g, device=cuda))
    w = torch.randn(n, generator=g, device=cuda)
    w[n - 100:] = 0.0
    w = w.view(R, 512)
    h = torch.randn(m1, generator=g, device=cuda)
    dots, upd = cpo.panel_dots.launches, cpo.panel_update.launches
    for k in (0, m1 - 1):
        V = torch.zeros(m1, n, device=cuda)
        V[: k + 1] = Q.T[: k + 1]
        V = V.to(dtype).view(m1, R, 512)
        kt = torch.tensor(k, dtype=torch.int32, device=cuda)
        part = cpo.panel_dots(V, w, kt)
        y, ss = cpo.panel_update(V, w, h, kt)
        torch.cuda.synchronize()
        partp = cpo.panel_dots_plain(V, w, kt)
        yp, ssp = cpo.panel_update_plain(V, w, h, kt)
        wn = float(torch.linalg.vector_norm(w))
        assert float((part - partp).abs().max()) <= 1e-5 * wn
        assert not part[k + 1:].any()
        assert y.dtype == torch.float32 and y.shape == w.shape
        assert _close(y, yp, 1e-6)
        assert abs(float(ss) - float(ssp)) <= 1e-5 * float(ssp)
    assert cpo.panel_dots.launches == dots + 2
    assert cpo.panel_update.launches == upd + 2


# ---- the distributed path on the card (tests/_torch_dist.py ranks) ----------


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["gloo-cuda", "nccl"])
def test_cuda_ranks_match_one_card(cuda, tmp_path, backend):
    """Distributed GMRES(20) and CG on the row-sharded laplacian(48,3) in
    rank processes, against the same solves on one card: two ranks sharing
    cuda:0 over gloo (as chip_smoke.py runs them), and one rank per card
    over NCCL where the machine has two or more cards.  The halo products
    within 1e-6 of max|y|, the dot 1e-5; GMRES (CGS2 against MGS) within one
    cycle and 1e-4 in x, CG within 2 steps and 1e-4; every step launches
    both sweeps twice."""
    from _torch_dist import launch

    from iterativesolvers_tpu_torch.ops import _build

    D = 2 if backend == "gloo-cuda" else torch.cuda.device_count()
    if D < 2:
        pytest.skip("NCCL takes one card per rank: needs two or more cards")
    _build.build_all()          # once here, not in every rank
    St = pits.laplacian(48, 3, device=cuda)
    spec = {"kind": "stencil", "n": St.n, "center": St.center,
            "terms": [list(t) for t in St.terms], "coeffs": list(St.coeffs),
            "dtype": "float32"}
    x = np.random.default_rng(0).standard_normal(St.n).astype(np.float32)
    b = np.ones(St.n, np.float32)
    kw = {"gmres": {"restart": 20, "reltol": 1e-5, "maxiter": 400},
          "cg": {"reltol": 1e-5}}
    cases = [({"name": "ops", "kind": "halo_ops", "op": spec}, {"x": x})] + [
        ({"name": s, "kind": s, "op": spec, "kw": kw[s]}, {"b": b})
        for s in kw]
    got = launch(cases, D, tmp_path, backend=backend, timeout=300)[0]
    xt, bt = torch.from_numpy(x).to(cuda), torch.from_numpy(b).to(cuda)
    y, d = St.mv_dot(xt)
    assert _close(torch.from_numpy(got["ops/mv"]), St.mv(xt).cpu(), 1e-6)
    assert _close(torch.from_numpy(got["ops/rmv"]), St.rmv(xt).cpu(), 1e-6)
    assert _close(torch.from_numpy(got["ops/mv_dot_y"]), y.cpu(), 1e-6)
    assert abs(float(got["ops/mv_dot"]) - float(d)) <= 1e-5 * abs(float(d))
    for solver, steps in (("gmres", 20), ("cg", 2)):
        x1, h1 = getattr(pits, solver)(St, bt, log=True, **kw[solver])
        assert bool(got[f"{solver}/converged"]) and h1.isconverged
        assert abs(int(got[f"{solver}/iters"]) - h1.iters) <= steps
        x1 = x1.double().cpu().numpy()
        xd = got[f"{solver}/x"].astype(np.float64)
        assert np.linalg.norm(xd - x1) <= 1e-4 * np.linalg.norm(x1)
    calls = int(got["gmres/calls/dist_panel_ortho"])
    assert calls == 20 * (int(got["gmres/restarts"]) + 1)
    assert int(got["gmres/calls/panel_dots"]) == 2 * calls
    assert int(got["gmres/calls/panel_update"]) == 2 * calls


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["stencil", "dia_f32", "dia_bf16",
                                  "dia_int8"])
def test_cuda_grid_dot_is_repeatable_within_its_bound(cuda, case):
    """The in-launch dot on the free grid (as many blocks as the SMs hold):
    the same bits on two runs of the same inputs, and within the
    rounding bound of its depth of the f64 dot (a thread's chain of L
    products, two 5-level trees a block_sum, the last block's chain over the
    partials: m additions, |error| <= 1.01 m 2^-24 sum |u_i y_i|)."""
    St = pits.laplacian(67, 3, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(St.n, generator=g, device=cuda)
    stream = cuda_stencil.raw_stream(x.device)
    if case == "stencil":
        op, R = St, cuda_stencil.STENCIL_RUN
        grid = cuda_stencil._launch(St.n, St.center, St.terms, St.coeffs,
                                    False, torch.float32, True, x.device,
                                    stream).grid
    else:
        dtype = {"dia_f32": torch.float32, "dia_bf16": torch.bfloat16,
                 "dia_int8": torch.int8}[case]
        op = pits.compress_values(pfix.laplace_dia(67, 3, dtype=np.float32,
                                                   device=cuda), dtype)
        assert op.dtype == dtype
        R = cuda_stencil.run_rows(dtype)
        grid = cuda_spmv._grid(dtype, True, len(op.diags), St.n, x.device,
                               stream)[0]
    (y1, d1), (y2, d2) = op.mv_dot(x), op.mv_dot(x)
    assert torch.equal(y1, y2) and torch.equal(d1, d2)
    prods = x.double() * y1.double()
    L = -(-(-(-St.n // R)) // (grid * 256)) * R
    m = L + 10 + -(-grid // 256) + 10
    bound = 1.01 * m * 2.0**-24 * float(prods.abs().sum())
    assert abs(float(d1) - float(prods.sum())) <= bound


# ---- mv_rows: the stencil and DIA kernels once per row ---------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", ["stencil f32", "stencil bf16", "dia_f32",
                                  "dia_bf16", "dia_int8"])
@pytest.mark.parametrize("side", [16, 21])
def test_cuda_mv_rows_is_mv_row_by_row(cuda, case, side):
    """``mv_rows`` of a (5, n) panel launches the operator's kernel once a
    row, and each row is the same bits as ``mv`` of it (a fresh copy);
    side 21 makes n odd, so the panel's rows start off the 16-byte
    boundary and take the kernels' per-row loads.  A column-major panel
    gives the same rows.  Within the f32 / bf16 tolerance of the plain
    batched version."""
    g = torch.Generator(device=cuda).manual_seed(side)
    if case.startswith("stencil"):
        op = pits.laplacian(side, 3, device=cuda)
        dtype = torch.float32 if case.endswith("f32") else torch.bfloat16
        counter = cuda_stencil.stencil_apply
    else:
        dtype = torch.float32
        op = pits.compress_values(pfix.laplace_dia(side, 3, dtype=np.float32,
                                                   device=cuda),
                                  {"dia_f32": torch.float32,
                                   "dia_bf16": torch.bfloat16,
                                   "dia_int8": torch.int8}[case])
        counter = cuda_spmv.dia_spmv
    n = op.shape[0]
    X = torch.randn(5, n, generator=g, device=cuda).to(dtype)
    before = counter.launches
    Y = op.mv_rows(X)
    assert counter.launches == before + 5
    assert Y.shape == (5, n) and Y.dtype == dtype
    for i in range(5):
        assert torch.equal(Y[i], op.mv(X[i].clone()))
    assert torch.equal(op.mv_rows(X.T.contiguous().T), Y)
    if case.startswith("stencil"):
        Yp = cuda_stencil.stencil_apply_plain(op.n, op.center, op.terms,
                                              op.coeffs, X.T).T
    else:
        Yp = cuda_spmv.dia_spmv_plain(op.diags, op.offsets, X.T).T
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    assert _close(Y, Yp, tol)


@pytest.mark.gpu
def test_cuda_mv_rows_past_the_kernel_limits_raise(cuda):
    """A panel of an operator past its kernel's limits raises before any
    row is launched, never a quiet plain run."""
    St = pits.laplacian(3, 5, device=cuda)           # 10 terms
    before = cuda_stencil.stencil_apply.launches
    with pytest.raises(ValueError, match="at most"):
        St.mv_rows(torch.ones(4, St.n, device=cuda))
    assert cuda_stencil.stencil_apply.launches == before


@pytest.mark.gpu
def test_cuda_lobpcg_gram_not_positive_definite_returns(cuda):
    """The indefinite B-Gram of tests/test_torch_eigsvd.py on the card:
    cholesky_ex's factor is NaN, eigh's input is guarded, and lobpcg
    returns the JAX package's answer there (no Ritz pair alive: the
    eigenvalue placeholders at float max, NaN vectors, not converged after
    one step) with no exception."""
    n = 40
    B = torch.diag(torch.cat([torch.ones(n // 2), -torch.ones(n - n // 2)]))
    X0 = torch.zeros(n, 2)
    X0[0] = 1.0
    X0[n // 2, 0] = X0[n // 2 + 1, 1] = 0.9
    A = torch.diag(torch.linspace(1.0, 10.0, n))
    r = pits.lobpcg(A.to(cuda, torch.float64), X0.to(cuda, torch.float64),
                    B=B.to(cuda, torch.float64), maxiter=20)
    assert (r.lam == torch.finfo(torch.float64).max).all()
    assert torch.isnan(r.X).all() and not r.converged
    assert r.iterations == 1


@pytest.mark.gpu
def test_cuda_lobpcg_and_block_cg_use_the_kernels(cuda):
    """LOBPCG and block CG on the stored and the matrix-free Laplacian at
    21^3 launch the kernel once per row of every panel product; LOBPCG's
    eigenvalues agree with the same solve on the CPU (the kernels' plain
    versions) within 2 tol: each run's Ritz values lie within its residual
    norm (at most tol) of eigenvalues of the matrix (Bauer-Fike for a
    symmetric matrix)."""
    A = pfix.laplace_dia(21, 3, dtype=np.float32, device=cuda)
    St = pits.laplacian(21, 3, device=cuda)
    g = torch.Generator().manual_seed(0)
    X0 = torch.randn(A.shape[0], 4, generator=g)
    lam_cpu = pits.lobpcg(pfix.laplace_dia(21, 3, dtype=np.float32,
                                           device="cpu"), X0, tol=1e-4,
                          maxiter=200).lam
    for op, counter in ((A, cuda_spmv.dia_spmv),
                        (St, cuda_stencil.stencil_apply)):
        before = counter.launches
        r = pits.lobpcg(op, X0.to(cuda), tol=1e-4, maxiter=200)
        assert counter.launches > before and r.converged
        torch.testing.assert_close(r.lam.cpu(), lam_cpu, rtol=0, atol=2e-4)
        B = torch.ones(A.shape[0], 3, device=cuda)
        B[:, 1:] = torch.randn(A.shape[0], 2, generator=g).to(cuda)
        before = counter.launches
        X, h = pits.block_cg(op, B, reltol=1e-5, log=True)
        assert h.isconverged and counter.launches == before + 3 * (
            pits.solvers.common.chunked_steps(h.iters) + 1)


# ---- the stored formats (operators/sparse.py): eager torch products ---------
@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["csr", "ell", "hyb", "hyb_adjoint", "bsr",
                                 "dia"])
def test_cuda_stored_formats_repeat_their_bits(cuda, fmt):
    """Each format's forward product (and the precomputed adjoint's) gives
    the same bits on two runs on the card (rows summed in order, no
    atomics), and agrees with the same product on the CPU within 1e-6 of
    max|y| (f32, another order of the same sums)."""
    def build(device):
        A = pfix.random_sparse(4000, 4000, 2e-3, seed=3, dtype=np.float32,
                               symmetrize=True, shift=4.0, device=device)
        return {"csr": lambda: A, "ell": A.to_ell,
                "hyb": lambda: A.to_hyb(row_width=4),
                "hyb_adjoint": lambda: A.to_hyb(row_width=4).with_adjoint(),
                "bsr": lambda: pits.BSRMatrix.from_csr(A, 4),
                "dia": lambda: pfix.laplace_dia(
                    16, 3, dtype=np.float32, device=device).to_csr().to_dia(),
                }[fmt]()
    op, op_cpu = build(cuda), build("cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(op.shape[1], generator=g)
    products = [lambda o, v: o.mv(v)]
    if fmt == "hyb_adjoint":
        products.append(lambda o, v: o.rmv(v))
    for prod in products:
        ya, yb = prod(op, x.to(cuda)), prod(op, x.to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(ya, yb)
        yc = prod(op_cpu, x)
        assert float((ya.cpu() - yc).abs().max()) <= 1e-6 * float(
            yc.abs().max())


@pytest.mark.gpu
def test_cuda_auto_format_of_laplacian_coo_lands_on_the_dia_kernel(cuda):
    """The Laplacian's COO triplets through CSRMatrix.from_coo and
    auto_format give laplace_dia's diagonals bit for bit, unpermuted, and
    CG on them launches dia_spmv_dot once a step."""
    rows, cols, vals, n = pfix.laplace_matrix_coo(21, 3, dtype=np.float32)
    A = pits.CSRMatrix.from_coo(rows, cols, vals, (n, n), device=cuda)
    op, perm = A.auto_format()
    want = pfix.laplace_dia(21, 3, dtype=np.float32, device=cuda)
    assert isinstance(op, pits.DIAMatrix) and perm is None
    assert op.offsets == want.offsets
    assert all(torch.equal(a, b) for a, b in zip(op.diags, want.diags))
    before = (cuda_spmv.dia_spmv_dot.launches, cuda_spmv.dia_spmv.launches)
    b = torch.ones(n, device=cuda)
    x, h = pits.cg(op, b, reltol=1e-5, log=True)
    steps = pits.solvers.common.chunked_steps(h.iters)
    assert h.isconverged
    assert (cuda_spmv.dia_spmv_dot.launches - before[0],
            cuda_spmv.dia_spmv.launches - before[1]) == (steps, 0)
    xc, hc = pits.cg(A, b, reltol=1e-5, log=True)
    assert hc.isconverged and abs(hc.iters - h.iters) <= 5
    assert float(torch.linalg.vector_norm(xc - x)
                 / torch.linalg.vector_norm(x)) <= 1e-4
