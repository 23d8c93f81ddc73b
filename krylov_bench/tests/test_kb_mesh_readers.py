"""The readers of the four-card cell's halo product and host dispatch
(``halo_stencil_roofline``, ``mesh_host_us_per_step``), on small synthetic
Chrome traces: rank 0's trace of a program whose phases replay CUDA graphs
and whose product is one launch of the stencil kernel's halo form, of one
that enqueues each step (the one-card launch on the block), and of one
card."""

import json

import pytest

from krylov_bench import harness, tracefile
from krylov_bench.tests.test_kb_metrics import (ALL_REDUCE, PEAKS, SEND_RECV,
                                                STENCIL, X, _cg_trace, _cell,
                                                _metric, _run)

HALO = ("void its::stencil_kernel<float, float, true>(float const*, float*, "
        "float*, unsigned int*, float*, int, int, its::StencilTerms, "
        "its::StencilHalo<float>)")
CELL = "cg.poisson7_4x216_4chip"
GRID = [16, 10, 10]


def _mesh_cell():
    return _cell(CELL, rows=1600, grid=GRID)


def _replayed_trace():
    """A calibration product (its exchange and one halo launch), then two
    solves of one replay of 4 steps: the host 20 us in ``its.replay``, the
    device a 20 us send/recv, a 10 us halo launch and three 5 us
    allreduces a step."""
    ev = [X("user_annotation", tracefile.CALIBRATE, 0, 100),
          X("kernel", SEND_RECV, 5, 20), X("kernel", HALO, 30, 10)]
    for s0 in (200, 1300):
        ev.append(X("user_annotation", tracefile.SOLVE, s0, 1000))
        ev.append(X("cpu_op", "its.replay", s0 + 2, 20))
        ev.append(X("cuda_runtime", "cudaGraphLaunch", s0 + 5, 15))
        for k in range(4):
            t = s0 + 30 + 200 * k
            ev += [X("kernel", SEND_RECV, t, 20),
                   X("kernel", HALO, t + 25, 10)]
            ev += [X("kernel", ALL_REDUCE, t + 40 + 10 * m, 5)
                   for m in range(3)]
    return ev


def _eager_trace():
    """The same solves with each step enqueued: 150 us of host in each
    ``its.step``, the one-card launch on the block."""
    ev = [X("user_annotation", tracefile.CALIBRATE, 0, 100),
          X("kernel", STENCIL, 30, 10)]
    for s0 in (200, 1300):
        ev.append(X("user_annotation", tracefile.SOLVE, s0, 1000))
        for k in range(4):
            t = s0 + 10 + 200 * k
            ev.append(X("cpu_op", "its.step", t, 150))
            ev.append(X("cuda_runtime", "cudaLaunchKernel", t + 5, 5))
            ev.append(X("kernel", STENCIL, t + 25, 10))
    return ev


def test_halo_product_bytes_against_the_hand_count():
    roof = _metric("halo_stencil_roofline")
    brick = json.loads((harness.BENCH_DIR / "configs" /
                        "poisson7_4x216.json").read_text())
    plane = 216 * 216
    assert roof.product_bytes(brick, 4) == 8 * 216 ** 3 + 2 * 4 * plane
    assert roof.product_bytes({"rows": 1600, "grid": GRID}, 4) == 3200 + 800


def test_mesh_readers_on_a_replayed_trace():
    run = _run(_mesh_cell(), _replayed_trace(), [3, 4])
    assert run.executed_steps() == 8
    # 4000 bytes a product at 3.35 TB/s over 10 us a launch
    want = 100 * (4000 / 3.35e12) / 10e-6
    assert _metric("halo_stencil_roofline").read(run) == pytest.approx(want)
    # 2 replays of 20 us over 8 steps
    assert _metric("mesh_host_us_per_step").read(run) == pytest.approx(5.0)
    assert _metric("collectives_per_step").read(run) == pytest.approx(4.0)


def test_mesh_readers_on_an_eager_trace():
    """A program that enqueues each step reads its host time; its product
    is no halo launch, so the roofline reads nothing."""
    run = _run(_mesh_cell(), _eager_trace(), [3, 4])
    assert run.executed_steps() == 8
    assert _metric("mesh_host_us_per_step").read(run) == pytest.approx(150.0)
    assert _metric("halo_stencil_roofline").read(run) is None


@pytest.mark.parametrize("name", ["halo_stencil_roofline",
                                  "mesh_host_us_per_step"])
def test_mesh_readers_find_nothing_on_one_card(name):
    run = _run(_cell("cg.poisson7_216", rows=1_000_000), _cg_trace(), [3, 4])
    assert _metric(name).read(run) is None
    assert _metric(name).read(harness.RunData(run.cell, "cpu", None)) is None
    assert _metric(name).read(harness.RunData(_mesh_cell(), "cpu",
                                              PEAKS)) is None
