"""The per-layer metrics' byte functions and trace readers, on a small
synthetic Chrome trace."""

import json

import pytest

from krylov_bench import harness, tracefile
from krylov_bench.tests import four_card

STENCIL = "void stencil_kernel<float, float, true>(float const*, int const*)"
ADD = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::CUDAFunctor_add<float> >(int, float*)")
PEAKS = {"memory_bytes_per_s": 3.35e12, "f32_flops_per_s": 6.7e13}


def _metric(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py")


def _cell(name, **overrides):
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    return harness.Cell(name, bench, overrides=overrides)


def X(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _cg_trace():
    """A calibration product (one stencil launch), then two solves of four
    steps: a 10 us stencil launch and a 30 us torch add a step, and one
    5 us fill a solve; the host sits in ``aten::item`` at each solve's end."""
    ev = [X("user_annotation", tracefile.CALIBRATE, 0, 100),
          X("kernel", STENCIL, 10, 10)]
    for s0 in (200, 1300):
        ev.append(X("user_annotation", tracefile.SOLVE, s0, 1000))
        ev.append(X("cpu_op", "aten::item", s0 + 600, 390))
        ev.append(X("gpu_memset", "Memset (Device)", s0 + 1, 5))
        for k in range(4):
            t = s0 + 10 + 100 * k
            ev.append(X("kernel", STENCIL, t, 10))
            ev.append(X("kernel", ADD, t + 20, 30))
    return ev


def _run(cell, events, iters):
    run = harness.RunData(cell, "NVIDIA H100 80GB HBM3", PEAKS)
    run.trace = tracefile.Trace(events)
    run.iters = iters
    return run


def test_byte_functions_against_the_hand_count():
    spmv = _metric("spmv_roofline")
    assert spmv.product_bytes("stencil", {"rows": 100}) == 800
    with pytest.raises(ValueError):
        spmv.product_bytes("dia_spmv", {"rows": 100})
    poisson = json.loads((harness.BENCH_DIR / "configs" /
                          "poisson7_216.json").read_text())
    assert poisson["rows"] == 216 ** 3
    assert spmv.product_bytes("stencil", poisson) == 8 * 216 ** 3


def test_trace_readers_on_a_synthetic_cg_trace():
    cell = _cell("cg.poisson7_216", rows=1_000_000)
    run = _run(cell, _cg_trace(), [3, 4])
    tr = run.trace
    assert tr.window() == (200, 2300)
    assert run.launches_per_product("stencil") == 1
    assert run.executed_steps() == 8
    assert _metric("steps_per_solve").read(run) == 3.5
    assert _metric("useful_step_share").read(run) == pytest.approx(87.5)
    # the torch adds and the fill: 2 * (4 * 30 + 5) us over 8 steps
    assert _metric("eager_us_per_step").read(run) == pytest.approx(31.25)
    # 8 bytes a row at 3.35 TB/s over 10 us a product
    want = 100 * (8e6 / 3.35e12) / 10e-6
    assert _metric("spmv_roofline").read(run) == pytest.approx(want)
    assert _metric("device_idle").read(run) is None    # no device-only pass
    bd = tr.breakdown()
    assert bd["device_ops"][0][0].startswith("at::native::vectorized")
    assert bd["device_ops"][0][1] == pytest.approx(240e-6)
    # the longest idle stretches: the host in aten::item at each solve's end
    assert bd["idle_gaps"][0][0] == "aten::item"


def test_launches_per_product_come_from_the_calibration():
    """A product that launches its kernel twice: steps and the roofline
    count both launches as one product."""
    cell = _cell("cg.poisson7_216", rows=1_000_000)
    ev = [X("user_annotation", tracefile.CALIBRATE, 0, 100),
          X("kernel", STENCIL, 10, 10), X("kernel", STENCIL, 30, 5),
          X("user_annotation", tracefile.SOLVE, 200, 1000)]
    ev += [X("kernel", STENCIL, 210 + 20 * k, 10) for k in range(8)]
    run = _run(cell, ev, [4])
    assert run.launches_per_product("stencil") == 2
    assert run.executed_steps() == 4
    assert _metric("useful_step_share").read(run) == pytest.approx(100.0)
    want = 100 * (8e6 / 3.35e12) / 20e-6
    assert _metric("spmv_roofline").read(run) == pytest.approx(want)


def test_device_idle_reads_the_device_only_pass():
    """Busy time is the union of that pass's device operations (the copy
    that overlaps a kernel counts once); the window is its host-clock
    length."""
    ev = [X("kernel", STENCIL, 100, 40),
          X("gpu_memcpy", "Memcpy DtoH", 120, 40),
          X("kernel", ADD, 300, 60), X("cpu_op", "aten::add", 0, 500)]
    spans = tracefile.device_intervals(ev)
    assert sorted(spans) == [(100, 140), (120, 160), (300, 360)]
    busy = sum(b - a for a, b in tracefile.merged(spans))
    assert busy == 120
    run = harness.RunData(_cell("cg.poisson7_216"), "cpu", None)
    run.device_busy_s, run.device_window_s = busy * 1e-6, 400e-6
    assert _metric("device_idle").read(run) == pytest.approx(70.0)


def test_readers_find_nothing_without_a_trace_or_a_data_sheet():
    cell = _cell("cg.poisson7_216")
    run = harness.RunData(cell, "cpu", None)
    for name in ("steps_per_solve", "useful_step_share", "eager_us_per_step",
                 "spmv_roofline", "device_idle",
                 "solve_ms", "solve_p90_ms"):
        assert _metric(name).read(run) is None, name
    run.trace = tracefile.Trace(_cg_trace())
    assert _metric("spmv_roofline").read(run) is None      # no peak: no share


def test_host_clock_metrics():
    cell = _cell("cg.poisson7_216")
    run = harness.RunData(cell, "cpu", None)
    run.setup_s = 7.5
    run.solve_times = [0.1 + 0.001 * i for i in range(100)]
    run.window_s = sum(run.solve_times) + 0.01
    assert _metric("setup_s").read(run) == 7.5
    assert _metric("solve_ms").read(run) == pytest.approx(
        run.window_s / 100 * 1e3)
    assert _metric("solve_p90_ms").read(run) == pytest.approx(189.1)


def test_kernel_families_classify_the_csrc_kernels():
    fams = tracefile.load_families()
    assert tracefile.family_of(STENCIL, fams) == "stencil"
    assert tracefile.family_of(ADD, fams) is None
    assert tracefile.family_of(
        "void at::native::reduce_kernel<512, 1>(at::native::ReduceOp)",
        fams) is None


SEND_RECV = "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"
ALL_REDUCE = ("ncclDevKernel_AllReduce_Sum_f32_RING_LL("
              "ncclDevKernelArgsStorage<4096ul>)")


def test_collective_readers_on_a_synthetic_four_rank_trace():
    """Rank 0's trace: a calibration product (its exchange and one stencil
    launch), then two solves of four steps, each a 20 us send/recv, a
    10 us stencil launch and three 5 us allreduces."""
    cell = harness.Cell(four_card.CELL["name"], four_card.bench(),
                        overrides={"rows": 4_000_000})
    ev = [X("user_annotation", tracefile.CALIBRATE, 0, 100),
          X("kernel", SEND_RECV, 5, 20), X("kernel", STENCIL, 30, 10)]
    for s0 in (200, 1300):
        ev.append(X("user_annotation", tracefile.SOLVE, s0, 1000))
        for k in range(4):
            t = s0 + 10 + 200 * k
            ev += [X("kernel", SEND_RECV, t, 20),
                   X("kernel", STENCIL, t + 25, 10)]
            ev += [X("kernel", ALL_REDUCE, t + 40 + 10 * m, 5)
                   for m in range(3)]
    run = _run(cell, ev, [3, 4])
    assert run.launches_per_product("stencil") == 1
    assert run.executed_steps() == 8
    assert _metric("collective_us_per_step").read(run) == pytest.approx(35.0)
    assert _metric("collectives_per_step").read(run) == pytest.approx(4.0)
    # rank 0's product covers a quarter of the rows: 8 * 4M / 4 bytes
    want = 100 * (8e6 / 3.35e12) / 10e-6
    assert _metric("spmv_roofline").read(run) == pytest.approx(want)


def test_collective_readers_find_nothing_on_one_card():
    run = _run(_cell("cg.poisson7_216", rows=1_000_000), _cg_trace(), [3, 4])
    for name in ("collective_us_per_step", "collectives_per_step"):
        assert _metric(name).read(run) is None, name
        assert _metric(name).read(harness.RunData(run.cell, "cpu",
                                                  None)) is None


def test_per_rank_bytes_of_a_product():
    spmv = _metric("spmv_roofline")
    brick = json.loads((harness.BENCH_DIR / "configs" /
                        "poisson7_4x216.json").read_text())
    assert brick["rows"] == 864 * 216 * 216 == 4 * brick["rows_per_chip"]
    assert spmv.product_bytes("stencil", brick, 4) == 8 * 216 ** 3
    assert spmv.product_bytes("stencil", brick) == 8 * brick["rows"]
