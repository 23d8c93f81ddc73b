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


@pytest.mark.gpu
def test_cuda_operators_past_the_kernel_limits_raise(cuda):
    """An operator sends a 1-D f32 CUDA x to its kernel whatever its size;
    past the kernel's limits the wrapper raises, never a quiet plain run."""
    St = pits.laplacian(3, 5, device=cuda)           # 10 terms
    assert len(St.terms) > cuda_stencil.MAX_TERMS
    with pytest.raises(ValueError, match="at most"):
        St.mv_dot(torch.ones(St.n, device=cuda))
    nd = cuda_spmv.MAX_DIAGS + 1
    A = pits.DIAMatrix([torch.ones(40, device=cuda)] * nd, tuple(range(nd)),
                       (40, 40), device=cuda)
    with pytest.raises(ValueError, match="at most"):
        A.mv(torch.ones(40, device=cuda))


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
@pytest.mark.parametrize("side", [1, 5, 67])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_stencil_panel_mv_matches_plain(cuda, side, dtype):
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
