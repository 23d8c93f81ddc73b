"""The plain reference against the port's plain CPU path at small sizes."""

import pytest
import torch

import iterativesolvers_tpu_torch as its
from krylov_bench import harness
from krylov_bench.reference import krylov
from krylov_bench.reference.brick import poisson7_brick
from krylov_bench.reference.operators import poisson7
from krylov_bench.reference.rbic import rbic


def _rand(n, seed, dtype=torch.float64):
    return torch.randn(n, generator=torch.Generator().manual_seed(seed),
                       dtype=dtype)


def test_poisson7_matches_the_port_stencil():
    side = 16
    x = _rand(side ** 3, 1)
    op = its.laplacian(side, 3, dtype=torch.float64, device="cpu")
    torch.testing.assert_close(poisson7(side)(x), op.mv(x), rtol=0, atol=1e-12)


def test_brick_matches_the_port_stencil_of_the_whole_grid():
    """The four-card cell's reference (its configuration's
    ``reference_operator``) against the port's own ``StencilOperator`` of
    the whole (24, 6, 6) grid, in float64 on the CPU."""
    config = harness.load_module(harness.BENCH_DIR / "configs"
                                 / "poisson7_4x216.py")
    nz, ny, nx = 24, 6, 6
    terms = []
    for stride, extent in ((1, nx), (nx, ny), (nx * ny, nz)):
        terms += [(stride, stride, extent), (-stride, stride, extent)]
    st = its.StencilOperator(nz * ny * nx, 6, tuple(terms), [-1] * 6,
                             dtype=torch.float64, device="cpu")
    x = _rand(st.n, 2)
    ref = config.reference_operator({"grid": [nz, ny, nx]})
    torch.testing.assert_close(ref(x), st.mv(x), rtol=0, atol=1e-12)
    torch.testing.assert_close(poisson7_brick((nz, ny, nx))(x), st.mv(x),
                               rtol=0, atol=1e-12)


def test_rbic_matches_the_port_preconditioner():
    side = 16
    x = _rand(side ** 3, 3)
    st = its.laplacian(side, 3, dtype=torch.float64, device="cpu")
    pre = its.RedBlackICPreconditioner.from_stencil(st)
    torch.testing.assert_close(rbic(side)(x), pre.ldiv(x), rtol=1e-13,
                               atol=1e-13)


@pytest.mark.parametrize("precond", [False, True])
def test_cg_matches_the_port(precond):
    side = 16
    b = _rand(side ** 3, 4)
    st = its.laplacian(side, 3, dtype=torch.float64, device="cpu")
    Pl = its.RedBlackICPreconditioner.from_stencil(st) if precond else None
    x, hist = its.cg(st, b, Pl=Pl, reltol=1e-8, log=True)
    x_ref, steps = krylov.cg(poisson7(side), b, rbic(side) if precond else None,
                             reltol=1e-8)
    assert steps == hist.iters
    torch.testing.assert_close(x, x_ref, rtol=1e-10, atol=1e-10)
