"""`BENCHMARK.json` against the benchmark's rules: names and units, every
file a name leads to, and each per-layer metric's `moves`."""
import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PB = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"


def test_names_and_units():
    names = [m["name"] for m in METRICS] + [w["name"] for w in BENCH["workloads"]] + \
        [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k), k
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]] + \
            [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])


def test_files_behind_the_names():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    used = set()
    for w in BENCH["workloads"]:
        cell = json.loads((PB / "cells" / f"{w['name']}.json").read_text())
        assert (cell["config"], cell["traffic"], cell["chips"]) == \
            (w["config"], w["traffic"], w["chips"])
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
        used.add(w["config"])
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in METRICS:
        assert (PB / "metrics" / f"{m['name']}.py").is_file(), m["name"]


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_an_end_to_end_metric_of_each_cell(m):
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in m["workloads"]:
        assert cell in cells
        assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [e for e in BENCH["end_to_end"] if w["name"] in e.get("workloads", [w["name"]])]
        assert "setup_s" in {e["name"] for e in e2e} and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_shares_are_named_as_such():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        if "mfu" in m["name"]:
            assert m["unit"] == "%"
