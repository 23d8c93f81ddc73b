"""The readings that the limits of the check are set from, in one process.

    python3 krylov_bench/readings.py --workload <cell> --mode program|control --seeds 1,2,3

For each seed: the right-hand sides of that seed, as many solves as a run
checks (``check_solves``, drawn from the pool by the seed), each against the
plain reference as a run checks it.  ``--mode control`` puts the cell's
control in the program's place: the reference one precision below the
configuration's (bfloat16), or where the program has such a path of its
own, the program with that path switched on.  One JSON line a seed, then one
with the worst reading of each number over the seeds.  The benchmark's own
runs never run this; it needs the card.  In a cell on several cards the
program's readings run the same rank processes as a run (``ranks.py``),
each rank solving on its rows and rank 0 checking the gathered answers;
the control is one process, since it is the reference on one card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import random
import sys
import time

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from krylov_bench import harness  # noqa: E402
from krylov_bench import ranks as team  # noqa: E402
from krylov_bench.traffic import rhs_pool  # noqa: E402


def readings(cell, seeds, mode="program", device="cuda", out=sys.stdout,
             ranks=None):
    """Per-seed readings (dicts) of ``mode``'s solves against the reference;
    with ``ranks`` (the program on several cards) rank 0's, and none on the
    other ranks."""
    import iterativesolvers_tpu_torch as its

    cfg = cell.config
    op = Pl = None                  # the control does not run the program
    if mode == "program":
        op = cell.port_operator(its, device, ranks)
        Pl = cell.precond.port(its, op, cfg) if cell.precond else None
    solve = harness.make_solve(cell, its, op, Pl, device, mode)
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        pool = rhs_pool(cell.traffic["rhs"], int(cfg["rows"]), seed, device)
        rhs = pool if ranks is None else ranks.local_rows(pool)
        rng = random.Random(seed)
        picks = [rng.randrange(pool.shape[0])
                 for _ in range(int(cell.workload["check_solves"]))]
        samples = []
        for i, j in enumerate(picks):
            x, steps = solve(rhs[j])
            samples.append((i, j, x if ranks is None else ranks.gather(x),
                            steps))
        if ranks is not None and not ranks.lead:
            continue
        checks, failed, each = harness.check(cell, pool, samples, device)
        row = {"seed": seed, "mode": mode, "failed": failed,
               "worst": {k: v["value"] for k, v in checks.items()},
               "each": each, "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), file=out, flush=True)
        del pool, samples
    if not rows:
        return rows
    names = rows[0]["worst"]
    summary = {"workload": cell.name, "mode": mode, "seeds": list(seeds),
               "worst": {k: max(r["worst"][k] for r in rows) for k in names},
               "least": {k: min(r["worst"][k] for r in rows) for k in names},
               "limits": cell.workload["limits"]}
    print(json.dumps(summary), file=out, flush=True)
    return rows


def on_ranks(cell, seeds, ranks):
    """The program's readings on this rank of a cell on several cards."""
    readings(cell, seeds, "program", ranks.device, ranks=ranks)
    ranks.close()


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--mode", choices=("program", "control"),
                        default="program")
    parser.add_argument("--seeds", required=True,
                        help="comma-separated seeds")
    harness.add_rank_options(parser)
    args = parser.parse_args(argv)
    import torch

    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(args.workload, bench)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    chips = cell.chips if args.mode == "program" else 1
    if not harness.has_cards(chips, args.workload):
        return 2
    torch.set_num_threads(1)
    if chips == 1:
        readings(cell, seeds, args.mode)
        return 0
    team.team_run(pathlib.Path(__file__).resolve(), argv, chips, "cuda",
                  args.rank, args.rendezvous,
                  lambda ranks: on_ranks(cell, seeds, ranks))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
