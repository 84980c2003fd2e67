"""Cells, configurations, mixes, references, drivers and metrics are found
by name, and `BENCHMARK.json` keeps to the benchmark's contract."""

import json
import re

import pytest

import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves_to_its_files(workload):
    entry, cfg, traffic = harness.cell(BENCH, workload)
    assert cfg["name"] == entry["config"]
    assert traffic["name"] == entry["traffic"]
    for kind in ("instances", "reference"):
        assert callable(getattr(harness.load(kind, cfg["name"]),
                                "draw" if kind == "instances"
                                else "dynamics"))
    driver = harness.load("drivers", traffic["driver"])
    assert callable(driver.setup) and callable(driver.window)
    assert set(cfg["checks"]) <= set(cfg["limits"])


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.load("metrics", m["name"]).read)
        for w in m.get("workloads", []):
            assert w in WORKLOADS


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        harness.cell(BENCH, "no_such_cell")
    with pytest.raises(FileNotFoundError):
        harness.load("metrics", "no_such_metric")


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]] + WORKLOADS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert all(len(w["why"]) <= 200 and w["chips"] == 1
               for w in BENCH["workloads"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        assert json.loads(open(harness.ROOT / c["file"]).read())["name"] \
            == c["name"]
    assert len(json.dumps(BENCH)) < 64 * 1024
