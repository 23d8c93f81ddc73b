"""The program's spans in one cell's traced solves, and what they cost.

    python3 krylov_bench/spanreport.py --workload <cell> --seed <n> [--rounds k]

Set-up as a run's, then the cell's ``traced_solves`` solves traced as a
``--trace 1`` run traces them (with the device's activity alone, then with
the host's operations too), in turns with the spans recorded and with them
switched off (``utils/profiling.span`` told that no profiler runs): on, off,
then off, on, for ``--rounds`` rounds.  One JSON line on standard output:

- ``ms_a_solve``: each pass's window a solve, spans on and off;
- ``sets``: the device operations of the last traced solves with spans, by
  the span that launched them (``spans.py``), with their device time and the
  part of it not built by the program's ``csrc/``;
- ``idle_s``: the solves' idle time by the innermost span the host was in;
- ``metrics``: the cell's per-layer metrics, read as a run reads them;
- ``order_agrees``: how many operations the matching by order gives the
  launch that their correlation id names, of how many carry one.

It needs the card; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from krylov_bench import harness, spans, tracefile  # noqa: E402
from krylov_bench.traffic import rhs_pool  # noqa: E402


@contextlib.contextmanager
def spans_off(profiling):
    """The program's spans record nothing inside the block, profiler or
    not."""
    saved = profiling._profiler_enabled
    profiling._profiler_enabled = lambda: False
    try:
        yield
    finally:
        profiling._profiler_enabled = saved


def report(cell, seed, rounds, device="cuda"):
    import torch

    import iterativesolvers_tpu_torch as its
    from iterativesolvers_tpu_torch.utils import profiling

    cfg = cell.config
    cuda = device == "cuda"
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    pool = rhs_pool(cell.traffic["rhs"], int(cfg["rows"]), seed, device)
    op = cell.config_module.port_operator(its, cfg, device)
    Pl = cell.precond.port(its, op, cfg) if cell.precond else None
    solve = harness.make_solve(cell, its, op, Pl, device)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    solve(pool[0])
    sync()
    k = int(cell.workload["traced_solves"])
    npool = pool.shape[0]
    solves = [lambda i=i: solve(pool[i % npool]) for i in range(k)]

    def host_pass():
        def body():
            with torch.profiler.record_function(tracefile.CALIBRATE):
                op.mv(pool[0])
                sync()
            out = []
            for fn in solves:
                with torch.profiler.record_function(tracefile.SOLVE):
                    out.append(fn())
                    sync()
            return out

        events, results = tracefile.profiled(body, cpu=True)
        trace = tracefile.Trace(events)
        lo, hi = trace.window()
        return (hi - lo) * 1e-3 / k, events, trace, results

    ms = {f"{p}_{m}": [] for p in ("device_pass", "host_pass")
          for m in ("on", "off")}
    kept = None
    for r in range(rounds):
        for mode in (("on", "off") if r % 2 == 0 else ("off", "on")):
            with (spans_off(profiling) if mode == "off"
                  else contextlib.nullcontext()):
                _, window, _ = tracefile.device_window(solves, sync)
                ms[f"device_pass_{mode}"].append(window * 1e-3 / k)
                w, events, trace, results = host_pass()
                ms[f"host_pass_{mode}"].append(w)
            if mode == "on":
                kept = (events, trace, results)
            del events, trace, results
    events, trace, results = kept
    run = harness.RunData(cell, kind, harness.device_peaks(kind))
    run.trace = trace
    run.iters = [int(steps) for _, steps in results]
    metrics = {}
    for m in cell.per_layer:
        mod = harness.load_module(harness.BENCH_DIR / "metrics"
                                  / f"{m['name']}.py")
        metrics[m["name"]] = mod.read(run)
    s = spans.Spans(trace)
    sets = {}
    for key, ops in s.ops.items():
        eager = sum(b - a for a, b, name in ops
                    if tracefile.family_of(name, run.families) is None)
        sets[key] = {"ops": len(ops), "device_us": s.device_us(key),
                     "eager_us": eager}
    total = sum(v["device_us"] for v in sets.values())
    stray = sum(sets.get(key, {}).get("device_us", 0.0)
                for key in (spans.OUTSIDE, spans.UNMATCHED))
    eager = sum(v["eager_us"] for v in sets.values())
    executed = run.executed_steps()
    return {
        "workload": cell.name, "seed": seed, "device": kind,
        "power": harness.power_limit() if cuda else None,
        "traced_solves": k,
        "live_steps": run.iters, "ms_a_solve": ms, "sets": sets,
        "outside_and_unmatched_share": stray / total if total else None,
        "eager_us_of_sets": eager,
        "eager_us_per_step_times_executed": (metrics.get("eager_us_per_step")
                                             or 0.0) * executed,
        "executed_steps_by_stencil": executed / k,
        "host_reads_per_solve": s.count(spans.SYNC) / k,
        "span_host_ms_per_solve": {
            name: s.host_us(name) * 1e-3 / k
            for name in (spans.STEP, spans.SYNC, spans.PRECOND, spans.SPMV,
                         spans.HISTORY)},
        "idle_s": s.idle_by_span(),
        "metrics": metrics,
        "order_agrees": spans.order_agrees(events),
    }


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(args.workload, bench)
    t0 = time.perf_counter()
    out = report(cell, args.seed, args.rounds)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
