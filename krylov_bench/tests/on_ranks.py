"""A cell on several cards run as gloo ranks on the CPU, for the tests:
what ``run.py`` and ``readings.py`` do on the cards, with the look for a
card skipped, the configuration resized and a fault of ``rank_faults.py``
planted in every rank.  From the root of a checkout whose manifest lists
the cell:

    python3 krylov_bench/tests/on_ranks.py run --workload <cell> --seed <n> --seconds <s> --overrides '<json>' [--fault <name>]
    python3 krylov_bench/tests/on_ranks.py readings --workload <cell> --mode program|control --seeds 1,2 --overrides '<json>'

``run`` prints what ``run.py`` prints; ``readings`` what ``readings.py``
does.  The control's readings stay one process, as there.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

SCRIPT = pathlib.Path(__file__).resolve()
sys.path[0] = str(SCRIPT.parents[2])

from krylov_bench import harness, readings  # noqa: E402
from krylov_bench import ranks as team  # noqa: E402


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("what", choices=("run", "readings"))
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int)
    parser.add_argument("--seconds", type=float)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--mode", choices=("program", "control"),
                        default="program")
    parser.add_argument("--seeds", default="")
    parser.add_argument("--overrides", type=json.loads, default={})
    parser.add_argument("--fault", help="a function of rank_faults.py")
    harness.add_rank_options(parser)
    args = parser.parse_args(argv)
    import torch

    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(args.workload, bench, args.overrides)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    torch.set_num_threads(1)
    if args.what == "readings" and args.mode == "control":
        readings.readings(cell, seeds, "control", "cpu")
        return 0

    def body(ranks):
        hook = None
        if args.fault:
            from krylov_bench.tests import rank_faults

            hook = getattr(rank_faults, args.fault)(ranks.rank)
        if args.what == "readings":
            readings.on_ranks(cell, seeds, ranks)
            return None, []
        return harness.run(cell, args.seed, args.seconds, bool(args.trace),
                           T0, ranks.device, hook, ranks)

    result, lines = team.team_run(SCRIPT, argv, cell.chips, "cpu", args.rank,
                                  args.rendezvous, body)
    return harness.report(result, lines)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
