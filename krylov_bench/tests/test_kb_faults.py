"""A run, with the look for a card skipped, at a small size on the CPU:
sound, it comes out correct; with the timed path broken underneath, not.
The cells on one card, in this process; those on several run as their rank
processes in ``test_kb_ranks.py``."""

import json
import time

import pytest
import torch

import iterativesolvers_tpu_torch.solvers.cg as port_cg
from krylov_bench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
SMALL = {"poisson7_216": {"side": 10, "rows": 1000}}
CELLS = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]


def _run(name, hook=None, seed=2 ** 31 + 11):
    config = [w for w in BENCH["workloads"] if w["name"] == name][0]["config"]
    cell = harness.Cell(name, BENCH, overrides=SMALL[config])
    result, _ = harness.run(cell, seed, 0.05, False, time.perf_counter(),
                            device="cpu", solve_hook=hook)
    return result


def unchanged(solve):
    """Every step returns its state: x stays at x0 = 0."""
    def broken(b):
        x, steps = solve(b)
        return torch.zeros_like(x), steps
    return broken


def half_left_out(solve):
    """Half of the answer's rows never computed (left at 0)."""
    def broken(b):
        x, steps = solve(b)
        x = x.clone()
        x[x.shape[0] // 2:] = 0
        return x, steps
    return broken


def altered(solve):
    """The answer altered where it is produced, by 0.1%."""
    def broken(b):
        x, steps = solve(b)
        return x * 1.001, steps
    return broken


def steps_altered(solve):
    """The right answer with a step count off by more than the limit."""
    def broken(b):
        x, steps = solve(b)
        return x, steps + 500
    return broken


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) >= {"solve_ms", "setup_s"}


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_answer_is_not_correct(cell, fault):
    result = _run(cell, fault)
    assert not result["correct"] and result["failed"] >= 1, result["checks"]


@pytest.mark.parametrize("cell", ["cg.poisson7_216", "pcg_rbic.poisson7_216"])
def test_a_wrong_step_count_is_not_correct(cell):
    result = _run(cell, steps_altered)
    assert not result["correct"], result["checks"]
    assert result["checks"]["step_gap"]["value"] == pytest.approx(
        500, abs=result["checks"]["step_gap"]["limit"])


def test_a_cg_step_that_returns_its_state_unchanged(monkeypatch):
    """Broken inside the program: the CG step leaves x, r and u as they were
    (only its counter moves, so the solve still ends)."""
    def step(op, Pl, state, live, log_in_place=False):
        return state._replace(k=state.k + live.to(state.k.dtype))
    monkeypatch.setattr(port_cg, "_cg_step", step)
    result = _run("cg.poisson7_216")
    assert not result["correct"]
    assert result["checks"]["x_gap"]["value"] == pytest.approx(1.0)


def _readings(cell, seeds, mode):
    import io

    from krylov_bench.readings import readings

    config = [w for w in BENCH["workloads"] if w["name"] == cell][0]["config"]
    c = harness.Cell(cell, BENCH, overrides=SMALL[config])
    return c, readings(c, seeds, mode, device="cpu", out=io.StringIO())


@pytest.mark.parametrize("cell", CELLS)
def test_readings_of_the_program_pass(cell):
    """``readings.py`` at a small size on the CPU."""
    _, rows = _readings(cell, [5, 6], "program")
    assert [r["failed"] for r in rows] == [0, 0], rows


@pytest.mark.parametrize("cell", CELLS)
def test_readings_of_the_control_fail(cell):
    """The control, the reference in bfloat16, fails at a small size too."""
    c, rows = _readings(cell, [5], "control")
    assert rows[0]["failed"] == c.workload["check_solves"], rows
