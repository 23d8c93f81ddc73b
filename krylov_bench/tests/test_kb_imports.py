"""No run loads JAX or the JAX package, and the reference loads nothing of
the program."""

import ast
import json
import subprocess
import sys

from krylov_bench import harness

ROOT = harness.ROOT


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", "import sys, json\nsys.path.insert(0, %r)\n%s\n"
         "print(json.dumps(sorted(sys.modules)))" % (str(ROOT), code)],
        capture_output=True, text=True, timeout=300, cwd=ROOT, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_top_level_names_are_compared_whole():
    assert harness.forbidden_modules(["iterativesolvers_tpu_torch",
                                      "iterativesolvers_tpu_torch.ops",
                                      "jaxtyping", "torch"]) == []
    assert harness.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax",
         "iterativesolvers_tpu", "iterativesolvers_tpu.ops"]) == [
        "flax", "iterativesolvers_tpu", "iterativesolvers_tpu.ops", "jax",
        "jax.numpy", "jaxlib.xla_client"]


def test_a_whole_run_loads_no_jax():
    """Each cell on one card run end to end at a small size on the CPU (a
    run on several cards checks every rank itself: ``test_kb_ranks.py``)."""
    mods = _modules_after(
        "import time\n"
        "from krylov_bench import harness\n"
        "bench = json.loads((harness.ROOT / 'BENCHMARK.json').read_text())\n"
        "for w in [w for w in bench['workloads'] if w['chips'] == 1]:\n"
        "    cell = harness.Cell(w['name'], bench,\n"
        "                        overrides={'side': 8, 'rows': 512})\n"
        "    res, _ = harness.run(cell, 7, 0.05, False, time.perf_counter(),\n"
        "                         device='cpu')\n"
        "    assert res['correct'], res")
    assert "iterativesolvers_tpu_torch" in mods
    assert harness.forbidden_modules(mods) == []


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules_after(
        "import krylov_bench.reference.krylov, krylov_bench.reference.rbic,"
        " krylov_bench.reference.operators, krylov_bench.reference.brick")
    assert not [m for m in mods if m.split(".")[0].startswith(
        "iterativesolvers_tpu")]
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] in ("torch", "math", "__future__"), (
                    path.name, name)


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints nothing on
    standard output."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "krylov_bench/run.py", "--workload",
         "cg.poisson7_216", "--seed", "4294967311", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
