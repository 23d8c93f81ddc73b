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
from iterativesolvers_tpu_torch.ops import cuda_spmv, cuda_stencil
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
