"""The halo form of the stencil product (``ops/cuda_stencil`` with ``base``,
``n_global``, ``left`` and ``right``): one rank's block of rows of a product
whose vector is split over ranks, the planes of the halo exchange read where
a column leaves the block.  On a card ``HaloStencilOperator`` takes it in
one launch; here its plain version is held against the whole vector's
product, against the operator's eager route (the interior, then the edge
terms of ``_edge_terms``) and against the benchmark's plain reference of
the brick, ``krylov_bench/reference/brick.py``.  Then CG on four gloo ranks
through the normal path against CG in float64, the mesh's spans, and which
solves replay their steps from CUDA graphs.

No JAX: the reference is plain PyTorch in float64.

Tolerance of the eager route against the halo form, on a block's edge rows
(the rows whose plane term reads the other rank's plane): the eager route
adds the plane term after the interior's sum, the halo form in its place in
ascending offset order.  The same seven f32 products are summed in another
order: each sum rounds each of its six partial sums once (unit roundoff
2^-24), so the two differ by at most 2 x 6 x 2^-24 < 2^-20 of the sum of
the |c x| of the row.  Every other row is the same bits.  The same bound
holds the halo form against the float64 reference (one f32 sum against an
exact one), and 1e-5 of sum |x y| the dot (another order of the block's
sum).
"""

import gc

import numpy as np
import pytest
import torch

from iterativesolvers_tpu_torch import StencilOperator
from iterativesolvers_tpu_torch.ops.cuda_stencil import stencil_apply_plain
from iterativesolvers_tpu_torch.parallel.sharded import (HaloStencilOperator,
                                                          RowMesh)
from iterativesolvers_tpu_torch.solvers.common import (_STEP_GRAPHS,
                                                       StepGraphs,
                                                       step_graphs)
from krylov_bench.reference import krylov
from krylov_bench.reference.brick import poisson7_brick

from _torch_dist import launch

GRIDS = {"24x6x6": (24, 6, 6), "32x8x6": (32, 8, 6)}
BOUND = 2.0 ** -20
PROCESS_TIMEOUT = 150


def _brick_terms(grid):
    """(center, terms, coeffs) of the 7-point Laplacian on the grid, in the
    term order of ``laplacian`` (as ``krylov_bench/configs/poisson7_4x216.py``
    builds it)."""
    nz, ny, nx = grid
    terms = []
    for stride, extent in ((1, nx), (nx, ny), (nx * ny, nz)):
        terms += [(stride, stride, extent), (-stride, stride, extent)]
    return 6.0, tuple(terms), (-1.0,) * len(terms)


class PlaneMesh(RowMesh):
    """Rank ``rank`` of a D-rank mesh in one process: the halo exchange
    hands back the planes of a whole vector (its ring neighbours' edge
    rows), and an allreduce leaves the local value."""

    def __init__(self, rank, size, whole, halo):
        super().__init__(rank, size, "cpu", "gloo")
        n_local = whole.shape[0] // size
        lo = rank * n_local
        self.planes = (torch.roll(whole, halo)[lo:lo + halo],
                       torch.roll(whole, -n_local)[lo:lo + halo])

    def exchange(self, first, last):
        self.counts["exchange"] += 1
        return self.planes

    def all_reduce(self, t, op="sum"):
        return t


def _blocks():
    for gname, grid in GRIDS.items():
        for D in (2, 4):
            for rank in range(D):
                yield pytest.param(gname, D, rank,
                                   id=f"{gname}-D{D}-rank{rank}")


@pytest.mark.parametrize("with_dot", [False, True])
@pytest.mark.parametrize("gname, D, rank", list(_blocks()))
def test_halo_form_is_the_block_of_the_whole_product(gname, D, rank,
                                                     with_dot):
    """The halo form of rank ``rank``'s block is that block of the whole
    vector's product bit for bit (the global ends included: what the ring
    wraps is masked), the eager route's within the reordered add on the
    edge rows and its bits elsewhere, and the brick's float64 reference
    within f32 rounding; with the dot, the block's share of <x, Ax>."""
    grid = GRIDS[gname]
    N = int(np.prod(grid))
    n, h = N // D, grid[1] * grid[2]
    base = rank * n
    center, terms, coeffs = _brick_terms(grid)
    whole = torch.from_numpy(np.random.default_rng(7 + rank).standard_normal(
        N).astype(np.float32))
    mesh = PlaneMesh(rank, D, whole, h)
    left, right = mesh.planes
    x = whole[base:base + n].clone()
    out = stencil_apply_plain(n, center, terms, coeffs, x, with_dot=with_dot,
                              base=base, n_global=N, left=left, right=right)
    y, dot = out if with_dot else (out, None)
    assert torch.equal(y, stencil_apply_plain(N, center, terms, coeffs,
                                              whole)[base:base + n])
    # the operator's product is the halo form, on the CPU as on a card;
    # its eager route (the interior, then the edge terms) is the other x's
    op = HaloStencilOperator(StencilOperator(N, center, terms, coeffs,
                                             dtype=torch.float32,
                                             device="cpu"), mesh)
    if with_dot:
        got, got_dot = op.mv_dot(x)
        assert torch.equal(got_dot, dot)
    else:
        got = op.mv(x)
    assert torch.equal(got, y)
    eager = op._eager(x, False, with_dot)
    eager = eager if with_dot else (eager, None)
    assert mesh.counts["exchange"] == 2
    absum = stencil_apply_plain(N, abs(center), terms,
                                tuple(abs(c) for c in coeffs),
                                whole.abs().double())[base:base + n]
    edge = torch.zeros(n, dtype=torch.bool)
    edge[:h] = edge[n - h:] = True
    assert torch.equal(y[~edge], eager[0][~edge])
    assert bool(((y - eager[0]).abs().double() <= BOUND * absum).all())
    ref = poisson7_brick(grid)(whole.double())[base:base + n]
    assert bool(((y.double() - ref).abs() <= BOUND * absum).all())
    if with_dot:
        xref = x.double()
        scale = float((xref * ref).abs().sum())
        assert abs(float(dot) - float(xref @ ref)) <= 1e-5 * scale
        assert abs(float(dot) - float(eager[1])) <= 1e-5 * scale


@pytest.mark.parametrize("bad", ["base only", "short plane", "outside"])
def test_halo_form_refuses_what_it_cannot_place(bad):
    """The halo form takes base, n_global and both planes together, planes
    that reach every offset, and a block inside the vector."""
    center, terms, coeffs = _brick_terms((8, 4, 4))
    x = torch.ones(64)
    plane = torch.ones(16)
    kw = {"base only": dict(base=0),
          "short plane": dict(base=64, n_global=128, left=plane[:8],
                              right=plane[:8]),
          "outside": dict(base=96, n_global=128, left=plane, right=plane)}
    with pytest.raises(ValueError):
        stencil_apply_plain(64, center, terms, coeffs, x, **kw[bad])


CG_CASES = {f"{g}-D{D}": (g, D) for g in GRIDS for D in (2, 4)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each D's launch of gloo rank processes, once for the module: CG on
    each grid from normal b, and the mesh's spans."""
    out = {}
    for D in (2, 4):
        cases, tmp = [], tmp_path_factory.mktemp(f"fold{D}")
        for g, grid in GRIDS.items():
            center, terms, coeffs = _brick_terms(grid)
            N = int(np.prod(grid))
            spec = {"kind": "stencil", "n": N, "center": center,
                    "terms": [list(t) for t in terms],
                    "coeffs": list(coeffs), "dtype": "float32"}
            b = np.random.default_rng(N).standard_normal(N).astype(np.float32)
            cases.append(({"name": f"cg/{g}", "kind": "cg", "op": spec,
                           "kw": {"reltol": 1e-6}}, {"b": b}))
            if g == "24x6x6":
                cases.append(({"name": "spans", "kind": "mesh_spans",
                               "op": spec}, {"x": b}))
                cases.append(({"name": f"pcg/{g}", "kind": "cg", "op": spec,
                               "kw": {"reltol": 1e-6, "jacobi": 6.0}},
                              {"b": b}))
        out[D] = launch(cases, D, tmp, timeout=PROCESS_TIMEOUT)
    return out


def _out(got, pre):
    return {k[len(pre) + 1:]: v for k, v in got.items()
            if k.startswith(pre + "/")}


@pytest.mark.parametrize("name", list(CG_CASES))
def test_cg_on_gloo_ranks_matches_float64_cg(ranks, name):
    """CG on D gloo ranks through the normal path (``cg`` on the
    ``HaloStencilOperator`` of the brick, steps enqueued one by one) against
    CG in float64 on the whole brick (``krylov_bench/reference/krylov``):
    both converge, within 2 steps, x within 1e-4 (f32 against f64 at reltol
    1e-6); every rank holds the same answer."""
    g, D = CG_CASES[name]
    grid = GRIDS[g]
    got = [_out(r, f"cg/{g}") for r in ranks[D]]
    N = int(np.prod(grid))
    b = torch.from_numpy(np.random.default_rng(N).standard_normal(N).astype(
        np.float32)).double()
    x64, steps = krylov.cg(poisson7_brick(grid), b, None, reltol=1e-6)
    for r in got:
        assert bool(r["converged"])
        np.testing.assert_array_equal(r["x"], got[0]["x"])
    assert abs(int(got[0]["iters"]) - steps) <= 2
    x = got[0]["x"].astype(np.float64)
    assert np.linalg.norm(x - x64.numpy()) <= 1e-4 * np.linalg.norm(x64)


@pytest.mark.parametrize("D", [2, 4])
def test_pcg_on_gloo_ranks_matches_float64_cg(ranks, D):
    """f32 CG with a diagonal preconditioner of one value on D gloo ranks
    (the step's <c, r> reduced on each rank and allreduced, then the
    direction; ``ops/cuda_cg.py``'s plain versions) against CG in float64
    on the whole brick, whose steps a constant diagonal does not change:
    both converge, within 2 steps, x within 1e-4; every rank holds the same
    answer."""
    grid = GRIDS["24x6x6"]
    got = [_out(r, "pcg/24x6x6") for r in ranks[D]]
    N = int(np.prod(grid))
    b = torch.from_numpy(np.random.default_rng(N).standard_normal(N).astype(
        np.float32)).double()
    x64, steps = krylov.cg(poisson7_brick(grid), b, None, reltol=1e-6)
    for r in got:
        assert bool(r["converged"])
        np.testing.assert_array_equal(r["x"], got[0]["x"])
    assert abs(int(got[0]["iters"]) - steps) <= 2
    x = got[0]["x"].astype(np.float64)
    assert np.linalg.norm(x - x64.numpy()) <= 1e-4 * np.linalg.norm(x64)


@pytest.mark.parametrize("D", [2, 4])
def test_mesh_collectives_record_their_spans(ranks, D):
    """Under a profiler, a halo product with its dot records one
    ``its.exchange`` and one ``its.allreduce``, and a norm one more
    ``its.allreduce``, on every rank."""
    for r in ranks[D]:
        got = _out(r, "spans")
        assert int(got["exchange"]) == 1
        assert int(got["allreduce"]) == 2


@pytest.mark.parametrize("backend, device, size, dtype, replays", [
    ("nccl", "cuda:0", 4, torch.float32, True),
    ("nccl", "cuda:1", 2, torch.bfloat16, True),
    ("nccl", "cuda:0", 4, torch.float64, False),
    ("nccl", "cuda:0", 1, torch.float32, False),
    ("gloo", "cuda:0", 4, torch.float32, False),
    ("gloo", "cpu", 4, torch.float32, False),
])
def test_steps_replay_on_a_mesh_of_cards_over_nccl(backend, device, size,
                                                   dtype, replays):
    """A solve's steps on a halo stencil are captured and replayed only on
    a mesh of several cards over NCCL, for the dtypes of the kernel's halo
    form; one StepGraphs a key (with no iteration limit in it), kept while
    the operator lives (nothing here touches a card)."""
    St = StencilOperator(*((64,) + _brick_terms((4, 4, 4))),
                         dtype=torch.float32, device="cpu")
    op = HaloStencilOperator(St, RowMesh(0, size, device, backend))
    key = ("cg", dtype, (64 // size,))
    got = step_graphs(op, dtype, key)
    assert op.capturable(dtype) is replays
    assert isinstance(got, StepGraphs) is replays
    assert not St.capturable(dtype)
    if replays:
        assert step_graphs(op, dtype, key) is got
        assert step_graphs(op, dtype, ("pipecg",) + key[1:]) is not got
        assert set(_STEP_GRAPHS[op]) == {key, ("pipecg",) + key[1:]}
        del op, got
        gc.collect()
        assert len(_STEP_GRAPHS) == 0
