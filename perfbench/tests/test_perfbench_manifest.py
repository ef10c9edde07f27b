"""The manifest against the contract's rules of form, and every name it
gives found as a file."""
import json
import re

import pytest

from perfbench import manifest

M = manifest.load()
CELLS = [w["name"] for w in M["workloads"]]


def test_form():
    assert manifest.problems(M) == []
    assert M["command"] == ["python3", "perfbench/run.py"]
    assert M["paths"] == ["perfbench"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


@pytest.mark.parametrize("bad", ["a b", "a,b", "a/b", "", "é", "x" * 65])
def test_names_refused(bad):
    m = json.loads(json.dumps(M))
    m["workloads"][0]["name"] = bad
    assert manifest.problems(m)


@pytest.mark.parametrize("bad", ["tokens per second", "", "µs", "x" * 17])
def test_units_refused(bad):
    m = json.loads(json.dumps(M))
    m["end_to_end"][0]["unit"] = bad
    assert manifest.problems(m)


def test_text_fields():
    for x in M["configs"] + M["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for x in M["configs"]:
        assert 1 <= len(x["source"]) <= 200
        assert x["file"].startswith("perfbench/")
    for x in M["per_layer"]:
        assert 1 <= len(x["layer"]) <= 200
    for x in M["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25


def test_check_budget():
    """A full check with 24 cells at this run length fits its time."""
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    w = manifest.workload(M, cell)
    cfg = manifest.read_json("configs", w["config"])
    traffic = manifest.read_json("traffic", w["traffic"])
    limits = manifest.read_json("limits", cell)["numbers"]
    assert limits and all("limit" in v for v in limits.values())
    manifest.module("generators", traffic["generator"])
    manifest.module("counters", cfg["counter"])
    assert w["chips"] == 1
    e2e = {x["name"] for x in manifest.end_to_end(M, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = manifest.per_layer(M, cell)
    assert layer
    for x in layer:
        assert x["moves"] in e2e
    assert set(manifest.readers(M, cell)) == {x["name"] for x in layer}


def test_layer_names_one_spelling():
    """Metrics of one layer name it letter for letter alike: no two
    spellings that differ only in case or spaces."""
    names = {x["layer"] for x in M["per_layer"]}
    folded = {re.sub(r"\s+", " ", n.lower()) for n in names}
    assert len(folded) == len(names)


def test_config_files_hold_what_runs():
    for x in M["configs"]:
        cfg = json.load(open(manifest.ROOT / x["file"]))
        assert cfg["name"] == x["name"] and cfg["reduced"] == x["reduced"]
        assert cfg["source"] == x["source"]
