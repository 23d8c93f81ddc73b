"""``BENCHMARK.json`` against the contract it is written to, and every file
that a cell's names lead to."""

import json
import re

import pytest

from krylov_bench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["krylov_bench"]
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert cmd[1].startswith("krylov_bench/")
    assert (harness.ROOT / cmd[1]).is_file()
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits into 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_sources():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] == 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in E2E
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_metric_workloads_name_cells_that_report_what_they_move():
    for m in METRICS:
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS, (m["name"], cell)
            if m in BENCH["per_layer"]:
                assert harness.applies(E2E[m["moves"]], cell), m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if harness.applies(m, cell)]
    layers = [m for m in BENCH["per_layer"] if harness.applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layers


def test_every_metric_has_a_reader():
    for m in METRICS:
        mod = harness.load_module(harness.BENCH_DIR / "metrics"
                                  / f"{m['name']}.py")
        assert callable(mod.read)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["why"]) and _line(c["source"])
        assert c["source"].startswith("https://")
        assert c["file"].startswith("krylov_bench/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in data
            assert not re.search(r"(_dim|_rank|hidden|size)$", key)
        assert (harness.BENCH_DIR / "configs" / f"{c['name']}.py").is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    w = [w for w in BENCH["workloads"] if w["name"] == cell][0]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and _line(w["why"])
    assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    c = harness.Cell(cell, BENCH)
    limits = c.workload["limits"]
    want = {"x_gap"} | ({"step_gap"} if c.solver.stops_on_tolerance(c.kwargs)
                        else set())
    assert set(limits) == want
    assert c.workload["check_solves"] >= 1 and c.workload["traced_solves"] >= 1
    assert c.step_family in {p.stem for p in
                             (harness.BENCH_DIR / "kernels").glob("*.json")}


def test_four_card_cells_are_at_most_a_quarter():
    """At most a quarter of the cells, rounded down, ask for four cards;
    one always may."""
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_pairs_appear_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
