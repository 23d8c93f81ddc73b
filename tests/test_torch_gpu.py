"""The port's CUDA kernels against their plain PyTorch versions on a card.

Every test here is marked ``gpu`` and skips where torch has no CUDA.  The
file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: f32 y within 1e-6 of max|y| (FMA contraction), bf16 y within
2e-2 (8 mantissa bits, rounded at other points), dots within 1e-5 relative
(another sum order).
"""

import ctypes

import numpy as np
import pytest
import torch

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.ops import (_launch, cuda_arnoldi, cuda_mgs,
                                           cuda_rbic, cuda_spmv, cuda_stencil)
from iterativesolvers_tpu_torch.utils import fixtures as pfix

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built by nvcc and "
                    "run only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_every_library_has_its_prototypes(cuda):
    """Every built library, loaded through ``_launch.library``: each of its
    ``extern "C"`` entries takes the argtypes of its prototype and returns
    an int."""
    from iterativesolvers_tpu_torch.ops import _build

    for name in sorted(_build.build_all()):
        lib = _launch.library(name)
        for entry, argtypes in _launch.prototypes(name).items():
            fn = getattr(lib, entry)
            assert fn.argtypes == argtypes, (name, entry)
            assert fn.restype is ctypes.c_int, (name, entry)


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
    smem = cuda_mgs._smem(cuda_mgs.DTYPE_CODE[dtype],
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
def test_cuda_mesh_forms_on_two_ranks_match_one_card(cuda, tmp_path):
    """Two ranks sharing cuda:0 over gloo: ``mv_rows`` of an (8, n) f32
    panel through the halo stencil (laplacian(48,3)) launches the stencil
    kernel once a row a rank with one exchange, each row within 1e-6 of
    max|y| of one card's ``mv_rows``; block CG with 4 right-hand sides
    takes one card's steps within 2, X within 1e-4; GMRES(20) on a dense
    f32 ``DenseMeshOperator`` of odd n (the padded last shard) launches
    both CGS2 sweeps twice a step and agrees with one card's solve within
    1e-4."""
    from _torch_dist import launch

    from iterativesolvers_tpu_torch.ops import _build

    _build.build_all()
    St = pits.laplacian(48, 3, device=cuda)
    spec = {"kind": "stencil", "n": St.n, "center": St.center,
            "terms": [list(t) for t in St.terms], "coeffs": list(St.coeffs),
            "dtype": "float32"}
    rng = np.random.default_rng(2)
    X = rng.standard_normal((8, St.n)).astype(np.float32)
    B = rng.standard_normal((St.n, 4)).astype(np.float32)
    n = 1001
    M = (np.eye(n) * 4.0 + 0.5 * rng.standard_normal((n, n)) / np.sqrt(n)
         ).astype(np.float32)
    gkw = {"restart": 20, "reltol": 1e-5, "maxiter": 200}
    cases = [({"name": "rows", "kind": "rows", "op": spec}, {"X": X}),
             ({"name": "bcg", "kind": "solve", "op": spec,
               "solver": "block_cg", "kw": {"reltol": 1e-5}}, {"b": B}),
             ({"name": "dense", "kind": "gmres", "op": {"kind": "dense"},
               "kw": gkw}, {"mat": M, "b": np.ones(n, np.float32)})]
    got = launch(cases, 2, tmp_path, backend="gloo-cuda", timeout=300)
    Y1 = St.mv_rows(torch.from_numpy(X).to(cuda)).cpu()
    for r in got:
        assert int(r["rows/launches"]) == 8 and int(r["rows/permutes"]) == 2
    assert _close(torch.from_numpy(got[0]["rows/Y"]), Y1, 1e-6)
    X1, h1 = pits.block_cg(St, torch.from_numpy(B).to(cuda), reltol=1e-5,
                           log=True)
    assert bool(got[0]["bcg/converged"]) and h1.isconverged
    assert abs(int(got[0]["bcg/iters"]) - h1.iters) <= 2
    X1 = X1.double().cpu().numpy()
    assert (np.linalg.norm(got[0]["bcg/x"] - X1)
            <= 1e-4 * np.linalg.norm(X1))
    x1 = pits.gmres(torch.from_numpy(M).to(cuda),
                    torch.ones(n, device=cuda), **gkw).double().cpu().numpy()
    assert bool(got[0]["dense/converged"])
    calls = int(got[0]["dense/calls/dist_panel_ortho"])
    assert calls == 20 * (int(got[0]["dense/restarts"]) + 1)
    assert int(got[0]["dense/calls/panel_dots"]) == 2 * calls
    assert int(got[0]["dense/calls/panel_update"]) == 2 * calls
    xd = got[0]["dense/x"].astype(np.float64)
    assert np.linalg.norm(xd - x1) <= 1e-4 * np.linalg.norm(x1)


@pytest.mark.gpu
def test_cuda_sharded_dia_on_four_ranks_matches_one_card(cuda, tmp_path):
    """Four ranks sharing cuda:0 over gloo: shard_dia of the two-field
    coupled f32 DIA at 2 x 16^3 (coupling diagonals at +-16^3, two blocks
    away): mv, rmv, mv_rows and mv_dot within 1e-6 of max|y| of one card's
    (the DIA kernel on each rank's block: mv and rmv one launch of
    ``dia_spmv`` each, mv_rows one a row, mv_dot one of ``dia_spmv_dot``),
    and 24 CG steps within 1e-5 of one card's."""
    from _torch_dist import launch

    from iterativesolvers_tpu_torch.ops import _build

    _build.build_all()
    L = pfix.laplace_dia(16, 3, dtype=np.float32, device="cpu")
    N = L.shape[0]
    diags = ([np.r_[np.zeros(N), np.full(N, 0.5)]]
             + [np.r_[d.numpy(), d.numpy()] + (0.6 if o == 0 else 0.0)
                for d, o in zip(L.diags, L.offsets)]
             + [np.r_[np.full(N, 0.5), np.zeros(N)]])
    offsets = [-N, *L.offsets, N]
    diags = [d.astype(np.float32) for d in diags]
    spec = {"kind": "dia", "ndiags": len(diags), "offsets": offsets,
            "shape": [2 * N, 2 * N], "shard": True}
    arrays = {f"diag{i}": d for i, d in enumerate(diags)}
    rng = np.random.default_rng(4)
    inp = {"x": rng.standard_normal(2 * N).astype(np.float32),
           "y": rng.standard_normal(2 * N).astype(np.float32),
           "X": rng.standard_normal((3, 2 * N)).astype(np.float32),
           "b": np.ones(2 * N, np.float32)}
    case = {"name": "coupled", "kind": "sharded", "op": spec,
            "do": ["products", "solves"],
            "solves": {"cg": {"reltol": 0.0, "maxiter": 24}}}
    got = launch([(case, {**arrays, **inp})], 4, tmp_path,
                 backend="gloo-cuda", timeout=300)
    A = pits.DIAMatrix([torch.from_numpy(d) for d in diags], offsets,
                       (2 * N, 2 * N), device=cuda)
    x = torch.from_numpy(inp["x"]).to(cuda)
    X = torch.from_numpy(inp["X"]).to(cuda)
    one = {"mv": A.mv(x), "rmv": A.rmv(torch.from_numpy(inp["y"]).to(cuda)),
           "mv_rows": A.mv_rows(X)}
    for key, want in one.items():
        assert _close(torch.from_numpy(got[0][f"coupled/products/{key}"]),
                      want.cpu(), 1e-6), key
    y1, d1 = A.mv_dot(x)
    assert abs(float(got[0]["coupled/products/mv_dot"]) - float(d1)) <= (
        1e-5 * abs(float(d1)))
    for r in got:
        assert int(r["coupled/products/launches/dia_spmv"]) == 1 + 1 + 3
        assert int(r["coupled/products/launches/dia_spmv_dot"]) == 1
    x1 = pits.cg(A, torch.ones(2 * N, device=cuda), reltol=0.0, maxiter=24)
    xs = torch.from_numpy(got[0]["coupled/solves/cg/x"])
    assert int(got[0]["coupled/solves/cg/iters"]) == 24
    assert float(torch.linalg.vector_norm(xs - x1.cpu())) <= 1e-5 * float(
        torch.linalg.vector_norm(x1))


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
    stream = _launch.raw_stream(x.device)
    if case == "stencil":
        op, R = St, cuda_stencil.STENCIL_RUN
        grid = cuda_stencil._launch_of(St.n, St.center, St.terms,
                                       St.coeffs, False, torch.float32, True,
                                       x.device, stream).grid
    else:
        dtype = {"dia_f32": torch.float32, "dia_bf16": torch.bfloat16,
                 "dia_int8": torch.int8}[case]
        op = pits.compress_values(pfix.laplace_dia(67, 3, dtype=np.float32,
                                                   device=cuda), dtype)
        assert op.dtype == dtype
        R = _launch.run_rows(dtype)
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


# ---- preconditioners and stationary sweeps (eager torch on the card) -----------

def _precond_applies(device):
    """name -> (build on ``device``, apply(P, x)) of every apply of the
    preconditioner slice, f64 on a 10^3 / 10^2 variable-coefficient grid."""
    def vd(side, dims):
        return pfix.variable_diffusion(side, dims, contrast=1e3, seed=3,
                                       device=device)

    def csr(side, dims):
        return vd(side, dims).to_csr()

    from iterativesolvers_tpu_torch.solvers import stationary as pst

    def sweep(method, ordering):
        def build():
            A = csr(10, 3)
            multicolor = ordering == "multicolor"
            split = pst._split_matrix(A, need_lower_solve=not multicolor,
                                      need_upper_solve=not multicolor)
            om = pst._omega(1.1, split)
            if not multicolor:
                return lambda x: pst._SWEEPS[method](split, x, x, om)
            color, nc = pst._color_classes(A)
            color = torch.from_numpy(color).to(device)
            return lambda x: pst._mc_sweep(method, nc, split, color, x, x, om)
        return build, lambda P, x: P(x)

    return {
        "level sweep": (lambda: pits.ICPreconditioner.from_operator(
            csr(10, 3)).lower_solve, lambda P, x: P.solve(x, omega=1.2)),
        "ilu natural ldiv_rows": (lambda: pits.ILUPreconditioner.from_operator(
            csr(10, 3)), lambda P, x: P.ldiv_rows(torch.stack([x, 2 * x]))),
        "ic multicolor ldiv": (lambda: pits.ICPreconditioner.from_operator(
            csr(10, 3), ordering="multicolor"), lambda P, x: P.ldiv(x)),
        "rbic from_dia ldiv": (lambda: pits.RedBlackICPreconditioner.from_dia(
            vd(10, 3), 10, 3), lambda P, x: P.ldiv(x)),
        "rbic from_stencil ldiv_rows": (
            lambda: pits.RedBlackICPreconditioner.from_stencil(
                pits.laplacian(10, 3, dtype=torch.float64, device=device)),
            lambda P, x: P.ldiv_rows(torch.stack([x, -x]))),
        "eisenstat mv": (lambda: pits.EisenstatSSOROperator.from_dia(
            vd(10, 3), 10, 3), lambda P, x: P.solution_transform(
                P.mv(P.rhs_transform(x)))),
        "rb_reduced mv": (lambda: pits.RBReducedSystem.from_dia(
            vd(10, 3), 10, 3), lambda P, x: P.expand_solution(
                *(lambda bb, br: (P.mv(bb), br))(*P.reduce_rhs(x)))),
        "ssor sweep": sweep("ssor", "natural"),
        "sor multicolor sweep": sweep("sor", "multicolor"),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_precond_applies("cpu")))
def test_cuda_precond_applies_match_cpu_without_host_reads(cuda, name):
    """Each apply on CUDA tensors against the same call on CPU tensors
    (f64, another order of the same sums: 1e-12), and with CUDA's sync
    debug mode at "error" around it: an ldiv, mv or sweep reads nothing
    back to the host (CG's masking and run_chunked rely on that)."""
    build, apply = _precond_applies(cuda)[name]
    build_cpu, _ = _precond_applies("cpu")[name]
    P, Pc = build(), build_cpu()
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1000, generator=g, dtype=torch.float64)
    apply(P, x.to(cuda))                  # warm-up outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = apply(P, x.to(cuda, non_blocking=True))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    yc = apply(Pc, x)
    assert float((y.cpu() - yc).abs().max()) <= 1e-12 * float(
        yc.abs().max())


@pytest.mark.gpu
def test_cuda_preconditioned_cg_launches_the_dia_kernel(cuda):
    """f32 CG on a variable-diffusion DIA matrix with RB-IC as Pl, and on
    the reduced system's explicit DIA form (25 diagonals): one dia_spmv_dot
    launch a step, two a step past 16 diagonals; the CPU solve's steps
    within 2."""
    A = pfix.variable_diffusion(16, 3, contrast=1e2, seed=7,
                                dtype=np.float32, device=cuda)
    b = torch.ones(A.shape[0], device=cuda)
    P = pits.RedBlackICPreconditioner.from_dia(A, 16, 3)
    R = pits.RBReducedSystem.from_dia(A, 16, 3)
    S = R.to_dia()
    assert len(S.offsets) > cuda_spmv.MAX_DIAGS
    for op, rhs, kw, per_step in ((A, b, {"Pl": P}, 1),
                                  (S, R.reduce_rhs(b)[0], {}, 2)):
        before = cuda_spmv.dia_spmv_dot.launches
        x, h = pits.cg(op, rhs, reltol=1e-5, log=True, **kw)
        steps = pits.solvers.common.chunked_steps(h.iters)
        assert h.isconverged
        assert cuda_spmv.dia_spmv_dot.launches - before == per_step * steps


def _grid_stencil(extents, coeffs, center, device):
    """A symmetric unit-step stencil on a grid of ``extents`` (stride 1
    first), coefficient ``coeffs[k]`` on both terms of axis k."""
    terms, cs, stride = [], [], 1
    for e, c in zip(extents, coeffs):
        terms += [(stride, stride, e), (-stride, stride, e)]
        cs += [c, c]
        stride *= e
    return pits.StencilOperator(stride, center, tuple(terms), cs,
                                device=device)


def _rbic_cases(cuda):
    """(stencil, shift) of the red-black IC(0) kernel's route: the main
    path's 216^3, an odd 3-D grid with a coefficient an axis, 2-D, 1-D and
    n < 32 grids, with and without a shift."""
    return {
        "laplacian 216^3": lambda: (pits.laplacian(216, 3, device=cuda), 0.0),
        "laplacian 216^3, shift": lambda: (
            pits.laplacian(216, 3, device=cuda), 0.5),
        "17x9x5, a coefficient an axis, shift": lambda: (_grid_stencil(
            (17, 9, 5), (-1.0, -0.7, -1.3), 6.0, cuda), 0.25),
        "2-D 67x33": lambda: (_grid_stencil((67, 33), (-1.0, -0.5), 3.0,
                                            cuda), 0.0),
        "1-D 1001, shift": lambda: (_grid_stencil((1001,), (-1.0,), 2.0,
                                                  cuda), 0.1),
        "n < 32: laplacian 3^3": lambda: (pits.laplacian(3, 3, device=cuda),
                                          0.0),
        "n < 32: 1-D 7": lambda: (_grid_stencil((7,), (-0.9,), 2.0, cuda),
                                  0.0),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_rbic_cases("cpu")))
@pytest.mark.parametrize("shift", [0, 1])
def test_cuda_rbic_matches_eager_apply(cuda, name, shift):
    """The red-black IC(0) kernel against its plain version (the eager
    apply, ``rbic_apply_plain``) on the same card, within 1e-6 of max|z|;
    shift = 1 hands it an x one element past a 16-byte boundary (a view),
    which pass 0 takes row by row; each ldiv counts one launch; twice on the
    same x (the plan's w reused) gives the same bits."""
    st, sh = _rbic_cases(cuda)[name]()
    P = pits.RedBlackICPreconditioner.from_stencil(st, shift=sh)
    assert P.form is not None
    g = torch.Generator(device=cuda).manual_seed(3)
    buf = torch.randn(st.n + shift, generator=g, device=cuda)
    x = buf[shift:]
    before = cuda_rbic.rbic_apply.launches
    z = P.ldiv(x)
    z2 = P.ldiv(x)
    ze = cuda_rbic.rbic_apply_plain([o for (o, _, _) in P.terms], P.mcs,
                                    P.s_inv, P.red, x)
    torch.cuda.synchronize()
    assert cuda_rbic.rbic_apply.launches == before + 2
    assert z.dtype == x.dtype and z.shape == x.shape
    assert float((z - ze).abs().max()) <= 1e-6 * float(ze.abs().max())
    assert torch.equal(z, z2)


@pytest.mark.gpu
def test_cuda_rbic_side_stream_takes_its_own_w(cuda):
    """An apply on another stream than the plan's takes a w of its own and
    gives the same bits; the plan keeps its stream's w."""
    P = pits.RedBlackICPreconditioner.from_stencil(
        pits.laplacian(40, 3, device=cuda))
    x = torch.randn(40**3, generator=torch.Generator(device=cuda).manual_seed(
        5), device=cuda)
    z = P.ldiv(x)
    w = P.form.plan.w
    side = torch.cuda.Stream(device=cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        zs = P.ldiv(x)
        zs2 = P.ldiv(-x)
    torch.cuda.synchronize()
    assert P.form.plan.w is w
    assert torch.equal(z, zs) and torch.equal(-z, zs2)


@pytest.mark.gpu
def test_cuda_rbic_other_callers_stay_eager(cuda):
    """from_dia, ldiv_rows, an (n, k) x, bf16 and f64 stencils do not
    launch the kernel."""
    A = pfix.variable_diffusion(12, 3, contrast=10.0, seed=1,
                                dtype=np.float32, device=cuda)
    P = pits.RedBlackICPreconditioner.from_stencil(
        pits.laplacian(12, 3, device=cuda))
    x = torch.randn(12**3, device=cuda)
    before = cuda_rbic.rbic_apply.launches
    pits.RedBlackICPreconditioner.from_dia(A, 12, 3).ldiv(x)
    P.ldiv_rows(torch.stack([x, -x]))
    P.ldiv(torch.stack([x, -x], 1))
    for dt in (torch.bfloat16, torch.float64):
        Q = pits.RedBlackICPreconditioner.from_stencil(
            pits.laplacian(12, 3, dtype=dt, device=cuda))
        assert Q.form is None
        Q.ldiv(x.to(dt))
    torch.cuda.synchronize()
    assert cuda_rbic.rbic_apply.launches == before


@pytest.mark.gpu
def test_cuda_rbic_pcg_takes_the_eager_steps(cuda):
    """f32 PCG with red-black IC(0) at 64^3: through the kernel, one launch
    an ldiv call, the same steps as through the eager apply within 1; no
    kernel instance spills or keeps a stack frame."""
    st = pits.laplacian(64, 3, device=cuda)
    P = pits.RedBlackICPreconditioner.from_stencil(st)
    b = torch.randn(st.n, generator=torch.Generator(device=cuda).manual_seed(
        9), device=cuda)
    calls = []

    def counted(r):
        calls.append(1)
        return P.ldiv(r)

    before = cuda_rbic.rbic_apply.launches
    _, h = pits.cg(st, b, reltol=1e-6, log=True,
                   Pl=pits.FunctionPreconditioner(counted))
    assert cuda_rbic.rbic_apply.launches - before == len(calls) > 0
    _, he = pits.cg(st, b, reltol=1e-6, log=True,
                    Pl=pits.FunctionPreconditioner(lambda r: P._apply(r, 0)))
    assert h.isconverged and he.isconverged
    assert abs(h.iters - he.iters) <= 1
    from iterativesolvers_tpu_torch.ops import _build
    res = {k: v for k, v in _build.kernel_resources("rbic").items()
           if "rbic_apply_kernel" in k}
    assert len(res) == 2
    assert all(v["spill_stores"] == v["spill_loads"] == v["stack"] == 0
               for v in res.values())


# ---- the halo form of the stencil kernel and the replayed mesh CG ----------

# grids (nz, ny, nx) split over D ranks in slabs of nz: planes of whole
# vectors (the 16-byte loads from the planes) and planes of odd length (one
# load a column there)
HALO_GRIDS = {"32x24x16": (32, 24, 16), "20x9x7": (20, 9, 7)}


def _halo_case(cuda, grid, D, rank, dtype):
    """The brick's stencil, the whole vector, this rank's block and its
    exchanged planes (the ring's neighbours' edge rows) on the card."""
    from test_torch_halo_fold import _brick_terms

    N = int(np.prod(grid))
    n, h = N // D, grid[1] * grid[2]
    lo = rank * n
    center, terms, coeffs = _brick_terms(grid)
    g = torch.Generator(device=cuda).manual_seed(11 + rank)
    whole = torch.randn(N, generator=g, device=cuda).to(dtype)
    planes = (torch.roll(whole, h)[lo:lo + h].contiguous(),
              torch.roll(whole, -n)[lo:lo + h].contiguous())
    return (center, terms, coeffs), whole, lo, n, h, planes


@pytest.mark.gpu
@pytest.mark.parametrize("grid", list(HALO_GRIDS))
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_halo_form_is_the_block_of_the_whole_product(cuda, grid, D,
                                                          dtype):
    """Each rank's halo-form launch, the planes passed in (no NCCL), is its
    block of the one-card kernel's product of the whole vector bit for bit
    (with the dot as without; D = 1: the one-card kernel and its halo form
    of one block give the same bits), its dot within 1e-5 of the block's
    sum; one launch a product.  The operator's eager edge route on the card
    (the one-card launch on the block, then the edge terms) gives the same
    bits off the edge rows and agrees within the reordered add on them
    (``tests/test_torch_halo_fold.py``)."""
    from test_torch_halo_fold import BOUND, PlaneMesh

    for rank in range(D):
        (center, terms, coeffs), whole, lo, n, h, (left, right) = _halo_case(
            cuda, HALO_GRIDS[grid], D, rank, dtype)
        args = (center, terms, coeffs)
        N = whole.shape[0]
        x = whole[lo:lo + n].clone()
        yw, dw = cuda_stencil.stencil_apply(N, *args, whole, with_dot=True)
        before = cuda_stencil.stencil_apply.launches
        for with_dot in (False, True):
            out = cuda_stencil.stencil_apply(
                n, *args, x, with_dot=with_dot, base=lo, n_global=N,
                left=left, right=right)
            y = out[0] if with_dot else out
            assert torch.equal(y, yw[lo:lo + n])
        assert cuda_stencil.stencil_apply.launches == before + 2
        xd, yd = x.double(), y.double()
        assert (abs(float(out[1]) - float(xd @ yd))
                <= 1e-5 * float((xd * yd).abs().sum()) + 1e-6)
        if D == 1 or dtype != torch.float32:
            continue
        mesh = PlaneMesh(rank, D, whole.cpu(), h)
        mesh.device = cuda
        mesh.planes = (left, right)
        op = pits.parallel.HaloStencilOperator(
            pits.StencilOperator(N, *args, dtype=dtype, device=cuda), mesh)
        assert torch.equal(op.mv(x), y)
        eager = op._eager(x, False)
        absum = cuda_stencil.stencil_apply_plain(
            N, abs(center), terms, tuple(abs(c) for c in coeffs),
            whole.abs().double().cpu())[lo:lo + n].to(cuda)
        edge = torch.zeros(n, dtype=torch.bool, device=cuda)
        edge[:h] = edge[n - h:] = True
        assert torch.equal(eager[~edge], y[~edge])
        assert bool(((eager - y).abs().double() <= BOUND * absum).all())


@pytest.mark.gpu
@pytest.mark.parametrize("D", [2, 4])
def test_cuda_replayed_mesh_cg_is_the_eager_mesh_cg(cuda, tmp_path, D):
    """CG on D NCCL ranks (one card each) on the (64, 32, 32) brick, from b
    and then from b2: its phases replayed from CUDA graphs, captured in the
    first solve and replayed again in the second, give the eager mesh
    solve's x and residual log bit for bit, and its steps; the replays run
    every executed step.  A third solve from b2 with a smaller maxiter
    replays the same graphs (no capture) and stops at maxiter, as the
    eager solve does.  Every rank reads the same late exit flags and stops
    after the same phase."""
    from _torch_dist import launch
    from test_torch_halo_fold import _brick_terms

    from iterativesolvers_tpu_torch.ops import _build
    from iterativesolvers_tpu_torch.solvers.common import chunked_steps

    if torch.cuda.device_count() < D:
        pytest.skip(f"NCCL takes one card per rank: needs {D} cards")
    _build.build_all()
    grid = (64, 32, 32)
    N = int(np.prod(grid))
    center, terms, coeffs = _brick_terms(grid)
    spec = {"kind": "stencil", "n": N, "center": center,
            "terms": [list(t) for t in terms], "coeffs": list(coeffs),
            "dtype": "float32"}
    rng = np.random.default_rng(D)
    b, b2 = (rng.standard_normal(N).astype(np.float32) for _ in range(2))
    short = 50
    got = launch([({"name": "g", "kind": "graph_cg", "op": spec,
                    "kw": {"reltol": 1e-6}, "short": short},
                   {"b": b, "b2": b2})],
                 D, tmp_path, backend="nccl", timeout=600)
    for r in got:
        steps = 0
        for tag in ("", "2", "3"):
            for key in ("x", "resnorm", "iters"):
                np.testing.assert_array_equal(r[f"g/graph{tag}/{key}"],
                                              r[f"g/eager{tag}/{key}"])
            assert bool(r[f"g/graph{tag}/converged"]) is (tag != "3")
            if tag != "3":
                steps += chunked_steps(int(r[f"g/graph{tag}/iters"]))
        assert int(r["g/graph3/iters"]) == short
        assert r["g/graph3/resnorm"].shape == (short,)
        np.testing.assert_array_equal(r["g/graph/x"], got[0]["g/graph/x"])
        assert int(r["g/replay_steps"]) == steps
        # every rank stopped after the same phase
        assert int(r["g/replays"]) == int(got[0]["g/replays"])
        assert 0 < int(r["g/graphs"]) < int(r["g/replays"])
        assert int(r["g/graphs3"]) == int(r["g/graphs"])


# ---- the CG step's vector kernels (csrc/cg_step.cu) ----------------------------

def _cg_vectors(cuda, n, seed=5):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(n, generator=g, device=cuda) for _ in range(5)]


def _close_sum(got, products):
    """A sum in the kernels' order against torch's f64 sum of the same f32
    products: within 1e-5 of the sum of their magnitudes (another order)."""
    p = products.double()
    return abs(float(got) - float(p.sum())) <= 1e-5 * float(p.abs().sum())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [67**3, 1001, 3])
def test_cuda_cg_step_kernels_are_the_eager_step_given_its_scalars(cuda, n):
    """Given the eager step's scalars, the direction and update launches
    write its u', x' and r' bit for bit (on the card ``addcmul`` is one
    fused multiply-add, but with ``value=-1`` it rounds the product first:
    the kernels round as it does); each sum is
    the plain version's on the launch's grid bit for bit, within 1e-5 of
    torch's; the residual is the correctly rounded square root, the count
    and the log slot advance; PCG's rho launch likewise.  n = 1001 and 3
    end in a part run (one load a row)."""
    from iterativesolvers_tpu_torch.ops import cuda_cg

    x, u, r, c, c2 = _cg_vectors(cuda, n)
    live = torch.ones((), dtype=torch.bool, device=cuda)
    rho_prev = torch.tensor(1.7, device=cuda)
    sigma = torch.sum(u * c2).abs() + 1.0
    dev = x.device
    plan = cuda_cg.launch_plan(n, dev, _launch.raw_stream(dev))
    dot = cuda_cg.cg_rho(c, r)
    assert torch.equal(dot, cuda_cg.cg_rho_plain(c, r, plan.grids[0]))
    assert _close_sum(dot, c * r)
    residual = torch.sqrt(torch.sum(r * r))
    for square, src in ((False, dot), (True, residual)):
        rho = src * src if square else src
        u_e = torch.addcmul((rho / rho_prev) * u, live.to(c.dtype), c)
        u2, rho2 = cuda_cg.cg_direction(c, u, src, rho_prev, live,
                                        square=square)
        assert torch.equal(u2, u_e) and torch.equal(rho2, rho)
    alpha = rho / sigma
    x_e = torch.addcmul(x, alpha, u2)
    r_e = torch.addcmul(r, alpha, c2, value=-1)
    k = torch.tensor(4, device=cuda)
    log = torch.zeros(8, device=cuda)
    x2, r2, res, k2 = cuda_cg.cg_update(x, u2, r, c2, rho, sigma, live,
                                        residual, k, log)
    assert torch.equal(x2, x_e) and torch.equal(r2, r_e)
    x3, r3, rr = cuda_cg.cg_update(x, u2, r, c2, rho, sigma, live)
    assert torch.equal(x3, x_e) and torch.equal(r3, r_e)
    assert torch.equal(rr, cuda_cg.kernel_sum(r_e * r_e, plan.grids[2]))
    assert _close_sum(rr, r_e * r_e)
    assert torch.equal(res, torch.sqrt(rr.double()).float())
    assert int(k2) == 5 and torch.equal(log[4], res)
    assert int((log != 0).sum()) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("precond", ["none", "rbic"])
def test_cuda_cg_masked_step_returns_its_state(cuda, precond):
    """A step masked off returns every field of its state bit for bit, and
    neither a live nor a masked step writes a tensor of the state it was
    given (``cg_iterator``'s checkpoints)."""
    from iterativesolvers_tpu_torch.solvers import cg as pcg

    st = pits.laplacian(24, 3, device=cuda)
    Pl = (pits.RedBlackICPreconditioner.from_stencil(st)
          if precond == "rbic" else pits.IdentityPreconditioner())
    it = pits.cg_iterator(st, _cg_vectors(cuda, st.n)[0], Pl=Pl)
    for _ in range(3):
        next(it)
    s = it.state
    on = torch.ones((), dtype=torch.bool, device=cuda)
    frozen = [t.clone() for t in s]
    off = pcg._cg_step(st, Pl, s, ~on)
    for a, f in zip(off, frozen):
        assert torch.equal(a, f) and a.dtype == f.dtype
    nxt = pcg._cg_step(st, Pl, s, on)
    assert int(nxt.k) == int(s.k) + 1 and nxt.x.dtype == torch.float32
    for a, f in zip(s, frozen):
        assert torch.equal(a, f)


@pytest.mark.gpu
def test_cuda_cg_step_kernels_launch_once_a_step(cuda):
    """f32 CG and RB-IC PCG launch the direction and update kernels once an
    executed step, and the rho kernel once a PCG step only; an f64 solve
    launches none.  Each solve's steps within 2 of the eager step's and x
    within 1e-4; no kernel spills or keeps a stack frame."""
    from iterativesolvers_tpu_torch.ops import _build, cuda_cg
    from iterativesolvers_tpu_torch.solvers.common import chunked_steps

    st = pits.laplacian(48, 3, device=cuda)
    b = _cg_vectors(cuda, st.n)[0]
    kernels = (cuda_cg.cg_rho, cuda_cg.cg_direction, cuda_cg.cg_update)
    for Pl, rho_per_step in ((None, 0), (
            pits.RedBlackICPreconditioner.from_stencil(st), 1)):
        before = [f.launches for f in kernels]
        x, h = pits.cg(st, b, Pl=Pl, reltol=1e-6, log=True)
        steps = chunked_steps(h.iters)
        got = [f.launches - n0 for f, n0 in zip(kernels, before)]
        assert h.isconverged and got == [rho_per_step * steps, steps, steps]
        takes = cuda_cg.takes
        cuda_cg.takes = lambda *v: False
        try:
            xe, he = pits.cg(st, b, Pl=Pl, reltol=1e-6, log=True)
        finally:
            cuda_cg.takes = takes
        assert abs(h.iters - he.iters) <= 2
        assert float(torch.linalg.vector_norm(x - xe)
                     / torch.linalg.vector_norm(xe)) <= 1e-4
    before = [f.launches for f in kernels]
    pits.cg(pits.laplacian(16, 3, dtype=torch.float64, device=cuda),
            torch.ones(16**3, dtype=torch.float64, device=cuda))
    assert [f.launches for f in kernels] == before
    res = {k: v for k, v in _build.kernel_resources("cg_step").items()
           if "cg_" in k and "kernel" in k}
    assert len(res) == 3
    assert all(v["spill_stores"] == v["spill_loads"] == v["stack"] == 0
               for v in res.values())


@pytest.mark.gpu
def test_cuda_cg_update_on_two_streams_at_once(cuda):
    """The update launch enqueued on two streams behind a sleep kernel each:
    each stream sums on partials and a ticket of its own, and every output
    equals the launch on the default stream, bit for bit."""
    from iterativesolvers_tpu_torch.ops import cuda_cg

    x, u, r, c, _ = _cg_vectors(cuda, 67**3)
    live = torch.ones((), dtype=torch.bool, device=cuda)
    rho, sigma = torch.tensor(2.5, device=cuda), torch.tensor(3.5, device=cuda)
    want = cuda_cg.cg_update(x, u, r, c, rho, sigma, live)
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    outs = ([], [])
    for s in streams:
        with torch.cuda.stream(s):
            torch.cuda._sleep(20_000_000)
    for _ in range(10):
        for s, out in zip(streams, outs):
            with torch.cuda.stream(s):
                out.append(cuda_cg.cg_update(x, u, r, c, rho, sigma, live))
    torch.cuda.synchronize()
    for out in outs:
        for got in out:
            assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_cuda_cg_step_kernels_refuse_bad_scalars_and_logs(cuda):
    """A 0-d input of another dtype, shape or card, or a log that is not a
    contiguous 1-D f32 tensor on the vectors' card, raises before a launch."""
    from iterativesolvers_tpu_torch.ops import cuda_cg

    x, u, r, c, _ = _cg_vectors(cuda, 1001)
    f32, on = torch.tensor(2.0, device=cuda), torch.tensor(True, device=cuda)
    k, log = torch.tensor(3, device=cuda), torch.zeros(8, device=cuda)
    before = (cuda_cg.cg_direction.launches, cuda_cg.cg_update.launches)
    for bad in (f32.double(), f32.reshape(1), f32.cpu()):
        with pytest.raises(ValueError, match="0-d"):
            cuda_cg.cg_direction(c, u, bad, f32, on)
        with pytest.raises(ValueError, match="0-d"):
            cuda_cg.cg_update(x, u, r, c, f32, bad, on)
    with pytest.raises(ValueError, match="0-d"):
        cuda_cg.cg_update(x, u, r, c, f32, f32, on, f32, k.int(), log)
    for bad_log in (log.double(), log.reshape(2, 4), log[::2], log.cpu()):
        with pytest.raises(ValueError, match="log"):
            cuda_cg.cg_update(x, u, r, c, f32, f32, on, f32, k, bad_log)
    assert (cuda_cg.cg_direction.launches,
            cuda_cg.cg_update.launches) == before


# ---- run_chunked's late exit read on the card ----------------------------------

def _late_exit_case(cuda, precond):
    st = pits.laplacian(32, 3, device=cuda)
    Pl = (pits.RedBlackICPreconditioner.from_stencil(st)
          if precond == "rbic" else None)
    return st, _cg_vectors(cuda, st.n)[0], Pl


@pytest.mark.gpu
@pytest.mark.parametrize("precond", ["none", "rbic"])
def test_cuda_late_exit_gives_the_bits_of_a_read_every_step(cuda, precond):
    """f32 CG and RB-IC PCG on a 32^3 stencil: the exit read one phase late,
    at the default phase, at 8, 32 and 256, gives x, the steps and the
    residual log of ``chunk=1`` (a waiting read before every step) bit for
    bit, and launches the stencil once an executed step, which
    ``chunked_steps`` counts."""
    from iterativesolvers_tpu_torch.solvers.common import CHUNK, chunked_steps

    st, b, Pl = _late_exit_case(cuda, precond)
    runs = {}
    for chunk in (1, 8, CHUNK, 32, 256):
        before = cuda_stencil.stencil_apply.launches
        x, h = pits.cg(st, b, Pl=Pl, reltol=1e-6, log=True, chunk=chunk)
        runs[chunk] = (x, h, cuda_stencil.stencil_apply.launches - before)
    x1, h1, _ = runs[1]
    assert h1.isconverged and h1.iters > 40
    for chunk, (x, h, launches) in runs.items():
        assert torch.equal(x, x1) and h.iters == h1.iters, chunk
        np.testing.assert_array_equal(h["resnorm"], h1["resnorm"])
        assert launches == chunked_steps(h.iters, chunk), chunk


@pytest.mark.gpu
@pytest.mark.parametrize("precond", ["none", "rbic"])
def test_cuda_no_host_wait_between_the_first_and_last_phase(cuda, tmp_path,
                                                            precond):
    """Traced, a CG / PCG solve on the card makes no stream or device
    synchronisation and no synchronous copy from its first step to its
    last: its exit reads wait on an event each (one after every phase but
    the first), and its copies to the host in that stretch go to pinned
    memory."""
    import json

    from iterativesolvers_tpu_torch.solvers.common import chunked_steps
    from iterativesolvers_tpu_torch.utils import profiling

    st, b, Pl = _late_exit_case(cuda, precond)
    pits.cg(st, b, Pl=Pl, reltol=1e-6)      # built and warm
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        x, h = pits.cg(st, b, Pl=Pl, reltol=1e-6, log=True)
    with open(tmp_path / "trace.json") as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"]

    def spans(name):
        return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in events if e.get("name") == name)

    steps, reads = spans("its.step"), spans("its.sync")
    assert len(steps) == chunked_steps(h.iters)
    phases = len(reads) - 1
    lo, hi = steps[0][0], steps[-1][1]
    calls = [e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    inside = [e for e in calls if lo <= float(e["ts"]) <= hi]
    waits = [e["name"] for e in inside
             if e["name"] in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                              "cudaMemcpy", "cuStreamSynchronize",
                              "cuCtxSynchronize", "cuMemcpyDtoH_v2")]
    assert waits == []
    copies = {e["args"]["correlation"]: e["name"] for e in events
              if e.get("cat") == "gpu_memcpy"
              and "correlation" in e.get("args", {})}
    for e in inside:
        if e["name"] == "cudaMemcpyAsync":
            name = copies.get(e.get("args", {}).get("correlation"))
            assert name is None or "Pinned" in name, name
    assert sum(e["name"] == "cudaEventSynchronize"
               for e in calls) == phases - 1


@pytest.mark.gpu
def test_cuda_lobpcg_and_svdl_keep_the_waiting_exit_read(cuda, monkeypatch):
    """On the card LOBPCG and svdl, whose steps read the host (``eigh``,
    ``svd``), make no late exit flags; CG makes one set a solve."""
    from iterativesolvers_tpu_torch.solvers import common as pcommon

    made = []
    real = pcommon._ExitFlags

    def counted():
        made.append(1)
        return real()

    monkeypatch.setattr(pcommon, "_ExitFlags", counted)
    A = pfix.laplace_dia(12, 3, dtype=np.float64, device=cuda)
    X0 = torch.randn(A.shape[0], 3, generator=torch.Generator().manual_seed(0),
                     dtype=torch.float64)
    assert pits.lobpcg(A, X0.to(cuda), tol=1e-4, maxiter=200).converged
    pits.svdl(A, nsv=2)
    assert made == []
    pits.cg(A, torch.ones(A.shape[0], dtype=torch.float64, device=cuda))
    assert made == [1]
