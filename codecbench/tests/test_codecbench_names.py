"""BENCHMARK.json keeps the contract's names and units, and every piece it
names is there."""
import json
import os
import re

import pytest

from codecbench import harness
from helpers import CELLS, ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_bounds_and_run_length():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    r = BENCH["run_seconds"]
    assert 1 <= r <= 51
    # a full check of 24 cells, each run with its allowance, fits 43200 s
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = harness.load_cell(cell, BENCH)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


def test_moves_names_an_end_to_end_metric_all_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in target.get("workloads", cells), (m["name"], cell)


def test_layer_names_agree_letter_for_letter():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len({x.lower() for x in layers}) == len(layers)


def test_every_piece_is_found_by_its_name():
    paths = BENCH["paths"]
    assert BENCH["command"][:3] == ["python3", "-m", "codecbench.run"]
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in paths)
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        harness.load("data", cfg["generator"])
    for w in BENCH["workloads"]:
        spec = json.load(open(os.path.join(
            harness.HERE, "workloads", w["name"] + ".json")))
        cfg = json.load(open(os.path.join(
            harness.HERE, "configs", spec["config"] + ".json")))
        assert spec["config"] == w["config"]
        assert spec["traffic"] == w["traffic"]
        # a cell's file holds what only the traffic decides; sizes are
        # the configuration's
        assert set(spec) == {"config", "traffic", "driver", "warmup_ops",
                             "profile_ops"}
        assert cfg["chunk_bytes"] > 0 and cfg["pool"] > 0
        assert hasattr(harness.load("drivers", spec["driver"]), "Driver")
    for m in METRICS:
        assert callable(harness.reader(m["name"]).read)


def test_a_split_of_a_quantity_is_read_by_the_quantity_s_reader():
    assert harness.reader("device_idle_pct.encode").__file__.endswith(
        os.path.join("metrics", "device_idle_pct.py"))
    assert harness.reader("kernels_roofline.anything").read is not None
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_quantity.encode")


def test_every_cell_file_names_its_pieces():
    for cell in CELLS:
        c = harness.load_cell(cell, BENCH)
        assert c.spec["config"] == cell.split(".")[0]
        assert hasattr(harness.load("drivers", c.spec["driver"]), "Driver")
