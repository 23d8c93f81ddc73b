"""On the card, at each cell's own size: the program's solves pass the
check's limits and the control's fail them (one seed each; the limits were
set from a dozen seeds and more, ``PERF.md``).  Run there with

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu krylov_bench/tests/test_kb_card.py
"""

import io
import json

import pytest
import torch

from krylov_bench import harness
from krylov_bench.readings import readings

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the port's CUDA kernels")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails_on_the_card(card, cell):
    c = harness.Cell(cell, BENCH)
    seed = 2 ** 31 + 977
    sound = readings(c, [seed], "program", out=io.StringIO())[0]
    assert sound["failed"] == 0, sound
    control = readings(c, [seed], "control", out=io.StringIO())[0]
    assert control["failed"] == c.workload["check_solves"], control
