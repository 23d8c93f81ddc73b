"""The port's kernels (``iterativesolvers_tpu_torch/ops``) against the
Pallas kernels they replace.

On the CPU each wrapper takes its kernel's plain PyTorch version; these tests
hold that version against the Pallas kernel run in interpret mode, at the
shapes and tolerances of ``tests/test_pallas.py``.  The CUDA kernels
themselves are held against the plain versions on a card by
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterativesolvers_tpu as jits
from iterativesolvers_tpu.ops import pallas_spmv, pallas_stencil
from iterativesolvers_tpu.utils.fixtures import advection_diffusion, laplace_dia

import iterativesolvers_tpu_torch as pits
from iterativesolvers_tpu_torch.ops import _launch, cuda_spmv, cuda_stencil
from iterativesolvers_tpu_torch.utils import fixtures as pfix

from _torch_port import port_dia, port_stencil, to_numpy, to_torch

torch.set_num_threads(1)


# ---------------- DIA SpMV (ops/pallas_spmv.py) ----------------------------


def _f32_dia(A):
    return type(A)(tuple(d.astype(np.float32) for d in A.diags), A.offsets,
                   A.shape)


def test_dia_plain_matches_pallas(rng):
    A = laplace_dia(16, 2, dtype=np.float32)  # n = 256
    x = rng.random(A.shape[0]).astype(np.float32)
    want = pallas_spmv.dia_spmv(A.diags, A.offsets, jnp.asarray(x),
                                block_rows=1024, interpret=True)
    got = cuda_spmv.dia_spmv_plain(port_dia(A).diags, A.offsets, to_torch(x))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_dia_plain_nonsymmetric_and_unaligned_n(rng):
    A = _f32_dia(advection_diffusion(8)[0])  # n = 512, nonsymmetric
    x = rng.random(A.shape[0]).astype(np.float32)
    want = pallas_spmv.dia_spmv(A.diags, A.offsets, jnp.asarray(x),
                                block_rows=1024, interpret=True)
    got = cuda_spmv.dia_spmv_plain(port_dia(A).diags, A.offsets, to_torch(x))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("side,dims,rtol,dot_tol", [
    (16, 2, 1e-5, 1e-3),    # one block
    (16, 3, 1e-4, 1e-2),    # n = 4096: four blocks of 1024
])
def test_dia_plain_dot_matches_pallas(rng, side, dims, rtol, dot_tol):
    A = laplace_dia(side, dims, dtype=np.float32)
    n = A.shape[0]
    x = rng.random(n).astype(np.float32)
    u = rng.random(n).astype(np.float32)
    y, d = pallas_spmv.dia_spmv_dot(A.diags, A.offsets, jnp.asarray(x),
                                    jnp.asarray(u), block_rows=1024,
                                    interpret=True)
    yp, dp = cuda_spmv.dia_spmv_plain(port_dia(A).diags, A.offsets,
                                      to_torch(x), to_torch(u))
    np.testing.assert_allclose(to_numpy(yp), np.asarray(y), rtol=rtol,
                               atol=rtol)
    assert abs(float(dp) - float(d)) < dot_tol * max(1.0, abs(float(d)))
    assert dp.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_dia_plain_compressed_diagonals_match_pallas(rng, dtype):
    """bf16 / int8 value streams, each product promoted to f32 (the streams
    ``compress_values`` makes for the bench's Laplacian)."""
    A = laplace_dia(16, 3, dtype=np.float32).astype(getattr(jnp, dtype))
    n = A.shape[0]
    x = rng.random(n).astype(np.float32)
    y, d = pallas_spmv.dia_spmv_dot(A.diags, A.offsets, jnp.asarray(x),
                                    jnp.asarray(x), block_rows=1024,
                                    interpret=True)
    P = port_dia(A)
    assert P.dtype == getattr(torch, dtype)
    yp, dp = cuda_spmv.dia_spmv_plain(P.diags, A.offsets, to_torch(x),
                                      to_torch(x))
    assert yp.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(yp), np.asarray(y), rtol=1e-4,
                               atol=1e-4)
    assert abs(float(dp) - float(d)) < 1e-2 * max(1.0, abs(float(d)))


def test_dia_wrapper_on_cpu_takes_plain_version(rng):
    P = pfix.laplace_dia(8, 2, dtype=np.float32, device="cpu")
    x = to_torch(rng.random(64).astype(np.float32))
    before = (cuda_spmv.dia_spmv.launches, cuda_spmv.dia_spmv_dot.launches)
    assert torch.equal(cuda_spmv.dia_spmv(P.diags, P.offsets, x),
                       cuda_spmv.dia_spmv_plain(P.diags, P.offsets, x))
    y, d = cuda_spmv.dia_spmv_dot(P.diags, P.offsets, x, x)
    yp, dp = cuda_spmv.dia_spmv_plain(P.diags, P.offsets, x, x)
    assert torch.equal(y, yp) and torch.equal(d, dp)
    # a launch is counted only where the kernel runs
    assert (cuda_spmv.dia_spmv.launches,
            cuda_spmv.dia_spmv_dot.launches) == before


def test_dia_wrapper_checks_its_arguments():
    P = pfix.laplace_dia(8, 2, dtype=np.float32, device="cpu")
    x = torch.ones(64)
    with pytest.raises(ValueError, match="1-D f32"):
        cuda_spmv.dia_spmv(P.diags, P.offsets, x.double())
    with pytest.raises(ValueError, match="1-D f32"):
        cuda_spmv.dia_spmv(P.diags, P.offsets, torch.ones(128)[::2])
    with pytest.raises(ValueError, match="x's length"):
        cuda_spmv.dia_spmv(P.diags, P.offsets, torch.ones(63))
    with pytest.raises(ValueError, match="one dtype"):
        cuda_spmv.dia_spmv((P.diags[0].half(),) + P.diags[1:], P.offsets, x)
    with pytest.raises(TypeError, match="f32, bf16 or int8"):
        cuda_spmv.dia_spmv(tuple(d.double() for d in P.diags), P.offsets, x)
    with pytest.raises(ValueError, match="u must match"):
        cuda_spmv.dia_spmv_dot(P.diags, P.offsets, x, torch.ones(32))


# ---------------- stencil SpMV (ops/pallas_stencil.py) ---------------------


def _stencil_check(St, conj=False, dtype=np.float32, seed=3):
    """Plain version against the Pallas kernel in interpret mode, with the
    tolerances of tests/test_pallas.py in f32 (the dot within 1e-5 * sqrt(n)
    of |dot|); in bf16 y within 2e-2 of max|y| and the dot within 2e-2 of
    |dot|, since both round to 8 mantissa bits at other points."""
    plan = pallas_stencil.stencil_plan(St.n, St.terms, conj=conj)
    assert plan is not None
    r = np.random.default_rng(seed)
    x = r.standard_normal(St.n).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    coeffs = [jnp.conj(c) if conj else c for c in St.coeffs]
    y, d = pallas_stencil.stencil_apply(
        plan, jnp.conj(St.center) if conj else St.center,
        [coeffs[i] for i in plan.inner_idx],
        [coeffs[i] for i in plan.outer_idx], xj, with_dot=True,
        interpret=True)
    Pt = port_stencil(St)
    xt = to_torch(np.asarray(xj))
    yp, dp = cuda_stencil.stencil_apply_plain(
        Pt.n, Pt.center, Pt.terms, Pt.coeffs, xt, conj=conj,
        with_dot=True)
    assert yp.dtype == xt.dtype and dp.dtype == torch.float32
    y = np.asarray(y.astype(jnp.float32))
    scale = float(np.max(np.abs(y)))
    tol = 1e-5 if dtype == np.float32 else 2e-2
    np.testing.assert_allclose(to_numpy(yp), y, rtol=tol, atol=tol * scale)
    dref = float(d)
    dot_tol = tol * St.n ** 0.5 if dtype == np.float32 else tol
    assert abs(float(dp) - dref) <= dot_tol * max(1.0, abs(dref))
    return plan


def test_stencil_plain_laplace_2d():
    _stencil_check(jits.laplacian(48, 2, dtype=np.float32))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_stencil_plain_laplace_3d_single_block(dtype):
    plan = _stencil_check(jits.laplacian(24, 3, dtype=np.float32), dtype=dtype)
    assert plan.nb == 1


def test_stencil_plain_multiblock_partial_tail():
    # 72^3 = 373248: two blocks, ragged last interior block
    plan = _stencil_check(jits.laplacian(72, 3, dtype=np.float32))
    assert plan.nb == 2 and plan.nb * plan.block > plan.n


@pytest.mark.parametrize("conj", [False, True])
def test_stencil_plain_nonsymmetric_and_adjoint(conj):
    _stencil_check(jits.advection_diffusion_stencil(24), conj=conj)


def test_stencil_plain_equals_dia_plain_bitwise(rng):
    """The kernel sums in ascending offset order, the order of the DIA
    kernel on the sorted offsets of ``laplace_dia``: the two forms of the
    Laplacian give the same bits (so f32 CG takes the same steps on both)."""
    St = pits.laplacian(12, 3, device="cpu")
    A = pfix.laplace_dia(12, 3, dtype=np.float32, device="cpu")
    x = to_torch(1e3 * rng.standard_normal(St.n).astype(np.float32))
    y, d = St.mv_dot(x)
    ya, da = A.mv_dot(x)
    assert torch.equal(y, ya) and torch.equal(d, da)


def test_stencil_wrapper_on_cpu_takes_plain_version(rng):
    St = pits.advection_diffusion_stencil(6, device="cpu")
    x = to_torch(rng.standard_normal(St.n).astype(np.float32))
    args = (St.n, St.center, St.terms, St.coeffs)
    before = cuda_stencil.stencil_apply.launches
    for conj in (False, True):
        assert torch.equal(cuda_stencil.stencil_apply(*args, x, conj=conj),
                           cuda_stencil.stencil_apply_plain(*args, x, conj=conj))
    y, d = cuda_stencil.stencil_apply(*args, x, with_dot=True)
    yp, dp = cuda_stencil.stencil_apply_plain(*args, x, with_dot=True)
    assert torch.equal(y, yp) and torch.equal(d, dp)
    assert cuda_stencil.stencil_apply.launches == before


def test_stencil_wrapper_checks_its_arguments():
    St = pits.laplacian(4, 2, device="cpu")
    args = (St.n, St.center, St.terms, St.coeffs)
    with pytest.raises(TypeError, match="f32 or bf16"):
        cuda_stencil.stencil_apply(*args, torch.ones(16, dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        cuda_stencil.stencil_apply(*args, torch.ones(15))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_stencil.stencil_apply(*args, torch.ones(32)[::2])
    # the kernel's limit is checked before a launch; the plain version,
    # which a CPU tensor takes, has none
    terms = ((1, 1, 4),) * (cuda_stencil.MAX_TERMS + 1)
    with pytest.raises(ValueError, match="at most"):
        cuda_stencil.check_kernel(16, terms)
    x = torch.arange(16.0)
    assert torch.equal(
        cuda_stencil.stencil_apply(16, 1.0, terms, (1.0,) * len(terms), x),
        cuda_stencil.stencil_apply_plain(16, 1.0, terms, (1.0,) * len(terms),
                                         x))


def test_stencil_operator_sends_only_real_1d_f32_bf16_to_the_kernel():
    """The eligibility rule of the TPU path (StencilOperator._pallas_plan):
    1-D, real, f32 or bf16; everything else takes ``_apply``."""
    St = pits.laplacian(4, 2, device="cpu")
    assert St._use_kernel(torch.ones(16))
    assert St._use_kernel(torch.ones(16, dtype=torch.bfloat16))
    assert not St._use_kernel(torch.ones(16, dtype=torch.float64))
    assert not St._use_kernel(torch.ones(16, dtype=torch.complex64))
    assert not St._use_kernel(torch.ones(16, 2))
    X = torch.arange(32, dtype=torch.float32).reshape(16, 2)
    Y = St.mv(X)
    for j in range(2):
        assert torch.allclose(Y[:, j], St.mv(X[:, j].contiguous()))


def _record(monkeypatch, module, name, calls):
    """Replace ``module.name`` by a pass-through that appends ``name`` to
    ``calls``."""
    fn = getattr(module, name)

    def record(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, record)


def test_operators_past_the_kernel_limits_still_go_to_the_wrapper(
        monkeypatch, rng):
    """The operators' rule has no size condition: a 1-D f32 x goes to the
    wrapper whatever the number of terms or diagonals, which raises on CUDA
    past the kernel's limits and takes the plain version on the CPU.  The
    DIA kernel's one limit is 32-bit row indices."""
    from iterativesolvers_tpu_torch.operators import sparse as psparse
    from iterativesolvers_tpu_torch.operators import stencil as pstencil

    St = pits.laplacian(3, 5, device="cpu")          # 10 terms, n = 243
    assert len(St.terms) > cuda_stencil.MAX_TERMS
    nd = cuda_spmv.MAX_DIAGS + 1
    offsets = tuple(range(-(nd // 2), nd - nd // 2))
    A = pits.DIAMatrix([to_torch(rng.standard_normal(40).astype(np.float32))
                        for _ in offsets], offsets, (40, 40), device="cpu")
    calls = []
    _record(monkeypatch, pstencil, "stencil_apply", calls)
    _record(monkeypatch, psparse, "dia_spmv", calls)
    _record(monkeypatch, psparse, "dia_spmv_dot", calls)
    monkeypatch.setattr(pstencil.StencilOperator, "_apply", None)
    x = to_torch(rng.standard_normal(St.n).astype(np.float32))
    St.mv(x), St.rmv(x), St.mv_dot(x)
    xa = to_torch(rng.standard_normal(40).astype(np.float32))
    A.mv(xa), A.mv_dot(xa)
    assert (calls.count("stencil_apply"), calls.count("dia_spmv"),
            calls.count("dia_spmv_dot")) == (3, 1, 1)
    # the DIA kernel takes any number of diagonals (in groups of
    # MAX_DIAGS a launch); its one limit is 32-bit row indices
    cuda_spmv._check_kernel(40, offsets)
    with pytest.raises(ValueError, match="32-bit"):
        cuda_spmv._check_kernel(_launch.max_rows(max(offsets)) + 1,
                                offsets)
