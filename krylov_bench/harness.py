"""One run of one cell of ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; the harness finds every
piece by that name: ``configs/<config>.json`` (the sizes, as run) with
``configs/<config>.py`` (the port's operator and the plain reference's),
``traffic/<traffic>.json`` (the solver, its arguments, the right-hand
sides), ``workloads/<cell>.json`` (the traced solves, the sample that is
checked, the limits of the check), ``solves/<solver>.py``,
``preconditioners/<name>.py`` and ``metrics/<metric>.py``.

A run: set-up (imports, the CUDA context, the port's kernels, the operator
and the right-hand sides from the seed, one warm-up solve), then either the
timed window (``--trace 0``: solves back to back until the first that ends
past ``--seconds``) or the traced solves (``--trace 1``), then the check of
a sample of the solves against the plain reference, once the program's
state is freed.  The last line of standard output is the result.

A cell on more than one card (``chips`` > 1) runs one rank process a card
(``ranks.py``): every rank runs the same set-up and the same solves on its
rows, the configuration's ``port_operator`` gets the mesh, and rank 0 times
the solves, reads its own trace, gathers the sampled answers after the
window and checks them.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import pathlib
import random
import subprocess
import sys
import time

from krylov_bench import ranks as team
from krylov_bench import tracefile
from krylov_bench.traffic import rhs_pool

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that no run may hold: JAX and the JAX package
# (the port's own name starts with the latter's, so names are compared
# whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "iterativesolvers_tpu")


def load_module(path: pathlib.Path):
    """The Python file ``path`` as a module of its own (names such as
    ``cg.poisson7_216`` are not identifiers, so files load by path)."""
    spec = importlib.util.spec_from_file_location(
        "krylov_bench._" + "_".join(path.with_suffix("").parts[-2:])
        .replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """Every file of one cell, found by its name in ``BENCHMARK.json``."""

    def __init__(self, name: str, bench: dict, overrides=None):
        entries = [w for w in bench["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = entries[0]
        self.name = name
        self.chips = int(w["chips"])
        self.config = json.loads(
            (BENCH_DIR / "configs" / f"{w['config']}.json").read_text())
        self.config.update(overrides or {})
        self.config_module = load_module(
            BENCH_DIR / "configs" / f"{w['config']}.py")
        self.traffic = json.loads(
            (BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
        self.workload = json.loads(
            (BENCH_DIR / "workloads" / f"{name}.json").read_text())
        self.solver = load_module(
            BENCH_DIR / "solves" / f"{self.traffic['solver']}.py")
        pre = self.traffic.get("preconditioner")
        self.precond = (load_module(BENCH_DIR / "preconditioners" / f"{pre}.py")
                        if pre else None)
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m, name)]

    def port_operator(self, its, device, ranks=None):
        """The port's operator of the configuration on ``device``; on
        several cards, this rank's part of it on ``ranks.mesh``."""
        if ranks is None:
            return self.config_module.port_operator(its, self.config, device)
        return self.config_module.port_operator(its, self.config, device,
                                                ranks.mesh)

    @property
    def kwargs(self) -> dict:
        return dict(self.traffic["kwargs"])

    @property
    def step_family(self) -> str:
        """The kernel family whose launches count the executed steps."""
        step = self.traffic["step_kernel"]
        return self.config["spmv_kernel"] if step == "spmv" else step


class RunData:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)``,
    a number or None where there is nothing to read)."""

    def __init__(self, cell: Cell, device_kind: str, peaks):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.device_kind = device_kind
        self.peaks = peaks              # the data sheet's entry, or None
        self.setup_s = None
        self.window_s = None
        self.solve_times = []           # seconds, each solve's own
        self.iters = []                 # live steps, each solve's history
        self.trace = None               # tracefile.Trace of a traced run
        self.device_busy_s = None       # device time of the solves traced
        self.device_window_s = None     # with the device's activity alone
        self.families = tracefile.load_families()

    def family_ops(self, family: str):
        """Device operations of ``family`` inside the traced solves."""
        return [op for op in self.trace.solve_ops()
                if tracefile.family_of(op[2], self.families) == family]

    def launches_per_product(self, family: str) -> int:
        """Launches of ``family`` in the traced product of the cell's
        operator, ``A.mv(x)``; 1 where it launched none of them."""
        n = sum(1 for op in self.trace.calibration_ops()
                if tracefile.family_of(op[2], self.families) == family)
        return max(n, 1)

    def executed_steps(self) -> float:
        """Steps run in the traced solves, masked ones included: launches of
        the step's kernel over its launches a product."""
        fam = self.cell.step_family
        return len(self.family_ops(fam)) / self.launches_per_product(fam)


def device_peaks(kind: str):
    table = json.loads((BENCH_DIR / "peaks.json").read_text())
    for key, entry in table.items():
        if key in kind:
            return entry
    return None


class Reservoir:
    """A uniform sample of ``k`` solves, drawn from the seed, of however many
    the window holds."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items = []

    def offer(self, index: int, item_fn):
        if len(self.items) < self.k:
            self.items.append(item_fn())
            return
        slot = self.rng.randrange(index + 1)
        if slot < self.k:
            self.items[slot] = item_fn()


def power_limit() -> str:
    """The card's name and power limit by ``nvidia-smi``, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def check(cell: Cell, pool, samples, device):
    """Each sampled solve against the plain reference in float64 on the same
    right-hand side: ``x_gap`` = |x - x_ref| / |x_ref|, and where the solve
    stops on tolerance ``step_gap`` = |steps - reference steps|.  Returns
    ``{name: {"value": worst over the sample, "limit": limit}}``, the
    number of sampled solves outside a limit, and each solve's readings."""
    import torch

    limits = cell.workload["limits"]
    A = cell.config_module.reference_operator(cell.config)
    M = (cell.precond.reference(cell.config, torch.float64, device)
         if cell.precond else None)
    refs = {}
    worst = {"x_gap": 0.0}
    tol_stop = cell.solver.stops_on_tolerance(cell.kwargs)
    if tol_stop:
        worst["step_gap"] = 0
    failed = 0
    each = []
    for _, j, x, steps in samples:
        if j not in refs:
            refs[j] = cell.solver.reference(A, M, pool[j], cell.kwargs)
        x_ref, steps_ref = refs[j]
        x64 = x.to(torch.float64)
        gap = float(torch.linalg.vector_norm(x64 - x_ref)
                    / torch.linalg.vector_norm(x_ref))
        readings = {"x_gap": gap}
        if tol_stop:
            readings["step_gap"] = abs(int(steps) - int(steps_ref))
        each.append(dict(readings, steps=int(steps), reference_steps=steps_ref))
        bad = False
        for name, value in readings.items():
            # NaN compares false: a solve that gives no number has failed
            if not value <= limits[name]:
                bad = True
            if not value <= worst[name]:
                worst[name] = value
        failed += bad
    return ({name: {"value": worst[name], "limit": limits[name]}
             for name in worst}, failed, each)


def make_solve(cell: Cell, its, op, Pl, device, mode="program"):
    """``solve(b) -> (x, live steps)``: the program's timed call, or with
    ``mode="control"`` the cell's control in its place (``readings.py``)."""
    import torch

    kwargs = cell.kwargs
    if mode == "program":
        return lambda b: cell.solver.port(its, op, Pl, b, kwargs)
    M16 = (cell.precond.reference(cell.config, torch.bfloat16, device)
           if cell.precond else None)
    ref_A = cell.config_module.reference_operator(cell.config)
    cap = int(cell.workload.get("control_maxiter", cell.config["rows"]))
    return lambda b: cell.solver.control(its, op, Pl, b, kwargs, ref_A, M16,
                                         cap)


def run(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", solve_hook=None, ranks=None):
    """One run; returns the result's dict (the keys of the result line) and the
    information lines.  ``solve_hook(solve)`` wraps the timed solve (the
    tests break it there).  With ``ranks`` (``ranks.Ranks``) this is one
    rank of a cell on several cards: each rank solves on its own rows, and
    a follower returns no result, only its line."""
    import torch

    import iterativesolvers_tpu_torch as its

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    phases = {"imports": time.perf_counter() - t0}
    cfg = cell.config
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    torch.zeros(1, device=device)
    phases["context"] = time.perf_counter() - t0
    data = RunData(cell, kind, device_peaks(kind) if cuda else None)
    pool = rhs_pool(cell.traffic["rhs"], int(cfg["rows"]), seed, device)
    op = cell.port_operator(its, device, ranks)
    if ranks is None:
        rhs = pool
        more = bool
    else:
        # every rank draws the whole pool and keeps its rows; rank 0 keeps
        # the pool for the check
        rhs = ranks.local_rows(pool)
        if not ranks.lead:
            del pool
        more = ranks.share
    Pl = cell.precond.port(its, op, cfg) if cell.precond else None
    sync()
    phases["inputs"] = time.perf_counter() - t0
    solve = make_solve(cell, its, op, Pl, device)
    if solve_hook is not None:
        solve = solve_hook(solve)
    npool = rhs.shape[0]
    solve(rhs[0])                                   # warm-up
    sync()
    data.setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sample = Reservoir(int(cell.workload["check_solves"]), seed)
    if trace:
        k = int(cell.workload["traced_solves"])
        # every rank traces its own solves; all take a trace again or none
        agree = ranks.all if ranks is not None else None
        # the device's busy time and the window it is taken over come from
        # the same solves, traced with the device's activity alone: the
        # host's operations go unrecorded, which slows a host-paced solve
        # less than recording them does
        busy, window, _ = tracefile.device_window(
            [lambda i=i: solve(rhs[i % npool]) for i in range(k)], sync, agree)
        data.device_busy_s = busy * 1e-6
        data.device_window_s = window * 1e-6
        # then the same solves with the host's operations too, for the
        # kernels' shares, the launch counts and the breakdown
        tr, results = tracefile.capture(
            lambda: op.mv(rhs[0]),
            [lambda i=i: solve(rhs[i % npool]) for i in range(k)], sync,
            agree)
        data.trace = tr
        for i, (x, steps) in enumerate(results):
            data.iters.append(steps)
            sample.offer(i, lambda: (i, i % npool, x, steps))
        attempted = k
    else:
        w0 = time.perf_counter()
        i = 0
        while True:
            j = i % npool
            a = time.perf_counter()
            x, steps = solve(rhs[j])
            sync()
            end = time.perf_counter()
            data.solve_times.append(end - a)
            data.iters.append(steps)
            sample.offer(i, lambda: (i, j, x.clone(), steps))
            i += 1
            # on several cards rank 0 decides, after its timing has ended
            if not more(end - w0 < seconds):
                break
        data.window_s = end - w0
        attempted = i
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if ranks is not None:
        own_peak, peak = peak, ranks.largest(peak)
        # each sampled answer whole, outside anything timed
        sample.items = [(i, j, ranks.gather(x), steps)
                        for i, j, x, steps in sample.items]
    del op, Pl, solve, x
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if ranks is not None:
        ranks.close()
        if not ranks.lead:
            return None, [f"rank {ranks.rank} on {device}: solves {attempted},"
                          f" live steps {min(data.iters)}-{max(data.iters)},"
                          f" memory_peak_bytes {own_peak}"]
    phases["warm-up"] = data.setup_s
    lines = [f"device: {kind}" + (f" ({power_limit()})" if cuda else ""),
             "set-up, seconds from the process's start to the end of: "
             + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()),
             f"solves {attempted}, live steps {min(data.iters)}-"
             f"{max(data.iters)}, memory_peak_bytes {peak}",
             "each solve, ms: " + " ".join(f"{t * 1e3:.1f}"
                                           for t in data.solve_times)]
    if trace:
        lo, hi = data.trace.window()
        lines.append(
            f"traced solves, ms a solve: device activity alone "
            f"{data.device_window_s * 1e3 / attempted:.1f} (busy "
            f"{data.device_busy_s * 1e3 / attempted:.1f}); with the host's "
            f"operations {(hi - lo) * 1e-3 / attempted:.1f}")
    c0 = time.perf_counter()
    checks, failed, _ = check(cell, pool, sample.items, device)
    lines.append(f"check of {len(sample.items)} solves against the reference:"
                 f" {time.perf_counter() - c0:.2f} s")
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py").read(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": failed == 0, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = data.device_busy_s
        dev["window_s"] = data.device_window_s
        result["breakdown"] = data.trace.breakdown()
    result["checks"] = checks
    return result, lines


def add_rank_options(parser):
    """A follower's rank and rendezvous (``ranks.py``), which the
    benchmark's own command never passes."""
    hidden = argparse.SUPPRESS
    parser.add_argument("--rank", type=int, default=0, help=hidden)
    parser.add_argument("--rendezvous", help=hidden)


def has_cards(chips: int, what: str) -> bool:
    """Whether this machine has the cards ``chips`` asks for; says why not
    on standard error."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: this benchmark runs only on the card",
              file=sys.stderr)
        return False
    if torch.cuda.device_count() < chips:
        print(f"{what} needs {chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return False
    return True


def report(result, lines) -> int:
    """Print a run's information lines and, on rank 0, its checks and its
    result line; refuse one in which JAX or the JAX package was loaded.
    Returns the exit code."""
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    if result is None:              # a follower: rank 0 prints the result
        return 0
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv, t0: float) -> int:
    parser = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json on this machine's card.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    add_rank_options(parser)
    args = parser.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell(args.workload, bench)
    import torch

    if not has_cards(cell.chips, args.workload):
        return 2
    # one process with few threads: the solves' host work is dispatch
    torch.set_num_threads(1)
    if cell.chips == 1:
        result, lines = run(cell, args.seed, args.seconds, bool(args.trace),
                            t0)
    else:
        result, lines = team.team_run(
            BENCH_DIR / "run.py", argv, cell.chips, "cuda", args.rank,
            args.rendezvous,
            lambda r: run(cell, args.seed, args.seconds, bool(args.trace), t0,
                          r.device, ranks=r))
    return report(result, lines)
