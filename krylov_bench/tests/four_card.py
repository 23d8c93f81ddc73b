"""The four-card cell that ``BENCHMARK.json`` does not list yet (its runs
on four H100s spread too widely for any bound, ``PERF.md``): its entry as
the manifest would list it, for the tests of the multi-rank path, and a
checkout whose manifest lists it."""

import json
import pathlib
import shutil

from krylov_bench import harness

CELL = {"name": "cg.poisson7_4x216_4chip", "config": "poisson7_4x216",
        "traffic": "cg_tol_1e-6", "chips": 4,
        "why": "CG to 1e-6 from normal b on 4 cards, 216^3 rows each, "
               "748-836 live steps (760 or 1016 run): weak scaling of "
               "cg.poisson7_216, NCCL halo exchange and allreduces"}


def bench() -> dict:
    """``BENCHMARK.json`` with the four-card cell added."""
    out = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    out["workloads"].append(dict(CELL))
    return out


def checkout(directory) -> pathlib.Path:
    """A checkout in ``directory`` whose manifest lists the four-card cell:
    ``bench()`` as its ``BENCHMARK.json``, a copy of the benchmark, and a
    link to the port."""
    root = pathlib.Path(directory)
    (root / "BENCHMARK.json").write_text(json.dumps(bench()))
    shutil.copytree(harness.BENCH_DIR, root / "krylov_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "iterativesolvers_tpu_torch").symlink_to(
        harness.ROOT / "iterativesolvers_tpu_torch")
    return root
