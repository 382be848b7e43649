"""BENCHMARK.json and the files it names: found by name, and within the
contract's limits."""

import json
import re

import pytest

from klbench import harness

ROOT = harness.KLBENCH.parent
BENCH = harness.benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["klbench"]
    assert BENCH["command"] == ["python3", "klbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entry_keys():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_is_found_by_name(cell):
    run = harness.make_run(ROOT, cell, 1, 1.0, False, "cpu", 0.0)
    assert harness.loop_module(run.traffic).Loop
    assert run.limits and all(v >= 0 for v in run.limits.values())
    for name, (read, unit) in harness.metric_readers(BENCH, cell).items():
        assert callable(read) and UNIT.match(unit)


def test_config_files_state_their_cuts():
    for c in BENCH["configs"]:
        doc = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("klbench/configs/")
        assert doc["reduced"] == c["reduced"] and doc["source"] == c["source"]
        for key in c["reduced"]:
            assert doc[key] != doc["published"][key]
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_e2e_and_a_per_layer(cell):
    e2e = [m for m in BENCH["end_to_end"] if cell in m.get("workloads",
                                                            [cell])]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_every_per_layer_metric_lists_its_cells():
    assert all(m["workloads"] for m in BENCH["per_layer"])
    bench = {"per_layer": [{"name": "idle_share.step", "unit": "%"}]}
    with pytest.raises(KeyError, match="lists no workloads"):
        harness.metric_readers(bench, CELLS[0])


def test_each_per_layer_metric_moves_an_e2e_its_cells_report():
    layers = {}
    for m in BENCH["per_layer"]:
        moved = E2E[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS)
        assert (harness.KLBENCH / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["layer"], m["name"])
    assert set(layers) <= {"device", "kernels", "launch path", "model step",
                           "entry"}


def test_bounds_are_within_the_contract():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert E2E["setup_s"]["bound"] <= 0.25


def test_the_run_budget_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
