"""A cell on several cards, run as its rank processes: the four-card cell
(``four_card.py``, in a checkout whose manifest lists it) as four gloo
ranks on the CPU at a small brick (24, 6, 6), through ``on_ranks.py``
(``run.py`` and ``readings.py`` with the look for a card skipped).  Sound,
it comes out correct; with the timed path broken underneath in every rank, not; with a
rank that dies, rank 0 exits with another code than 0 and prints no
result."""

import json
import subprocess
import sys
import time

import pytest

from krylov_bench import ranks
from krylov_bench.tests import four_card

CELL = four_card.CELL["name"]
BRICK = {"grid": [24, 6, 6], "rows": 864, "rows_per_chip": 216}
TIMEOUT = 180


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return four_card.checkout(tmp_path_factory.mktemp("checkout"))


def _command(root, what, *args, fault=None):
    cmd = [sys.executable, "krylov_bench/tests/on_ranks.py", what,
           "--workload", CELL, *args, "--overrides", json.dumps(BRICK)]
    if fault:
        cmd += ["--fault", fault]
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=TIMEOUT, cwd=root)


def _run(root, fault=None, seed=2 ** 31 + 29):
    out = _command(root, "run", "--seed", str(seed), "--seconds", "0.3",
                   "--trace", "0", fault=fault)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_a_sound_run_on_four_ranks_is_correct(root):
    result, err = _run(root)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert result["device"]["count"] == 4
    assert set(result["metrics"]) >= {"solve_ms", "setup_s"}
    assert list(result)[-1] == "checks"
    # every follower ran the window's solves
    for r in (1, 2, 3):
        assert f"rank {r} on cpu: solves {result['attempted']}," in err


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out",
                                   "exchange_left_out", "altered"])
def test_a_broken_run_on_four_ranks_is_not_correct(root, fault):
    result, _ = _run(root, fault)
    assert not result["correct"] and result["failed"] >= 1, result["checks"]


def test_a_rank_that_dies_fails_the_run_at_once(root):
    t0 = time.monotonic()
    out = _command(root, "run", "--seed", "7", "--seconds", "30", "--trace",
                   "0", fault="rank_dies")
    took = time.monotonic() - t0
    assert out.returncode == ranks.FOLLOWER_FAILED, out.stderr[-4000:]
    assert out.stdout == ""
    assert "rank 2 exited with code 9" in out.stderr
    # well before the window's 30 s and the collectives' timeout
    assert took < 30, took


def test_readings_of_the_program_on_four_ranks_pass(root):
    out = _command(root, "readings", "--mode", "program", "--seeds", "5,6")
    assert out.returncode == 0, out.stderr[-4000:]
    rows = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert [r["failed"] for r in rows[:2]] == [0, 0], rows
    assert rows[-1]["seeds"] == [5, 6]


def test_readings_of_the_control_fail_in_one_process(root):
    out = _command(root, "readings", "--mode", "control", "--seeds", "5")
    assert out.returncode == 0, out.stderr[-4000:]
    row = json.loads(out.stdout.strip().splitlines()[0])
    assert row["failed"] == 3, row
    assert "rank 1" not in out.stderr
