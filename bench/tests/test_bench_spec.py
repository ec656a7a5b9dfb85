"""BENCHMARK.json against the benchmark's contract, and every entry found
from its own file; a new configuration, traffic, cell or metric is found
once its files and entries are added."""
from __future__ import annotations

import json
import re

import benchutil
import pytest

from fedbench import cli

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((benchutil.REPO / "BENCHMARK.json").read_text())
SPEC = cli.Spec(benchutil.REPO)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert all("/" not in w or w.startswith("bench/") for w in BENCH["command"][1:])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((benchutil.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("what", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(what):
    names = [e["name"] for e in BENCH[what]]
    assert len(names) == len(set(names))
    for e in BENCH[what]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("config", "traffic"):
            if k in e:
                assert NAME.match(e[k])
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_end_to_end_contract():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert {"setup_s", "step_ms", "peak_mem_gb"} <= names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_contract():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len(BENCH["per_layer"]) == 9 and len(layers) >= 5
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] == "step_ms"
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    w = SPEC.workload(cell)
    assert w["chips"] == 1 and set(w) == {"name", "config", "traffic", "chips", "why"}
    cfg = SPEC.config(w["config"])
    assert cfg["name"] == w["config"] and cfg["kind"] == "fedais"
    traffic = SPEC.traffic(w["traffic"])
    assert traffic["cohort"] <= traffic["partition"]["n_clients"]
    limits = SPEC.limits(cell)
    from fedbench import judge
    assert set(judge.NAMES) == set(limits)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(SPEC.reader(metric))


def test_configs_keep_published_widths():
    for c in BENCH["configs"]:
        cfg = json.loads((benchutil.REPO / c["file"]).read_text())
        assert c["file"].startswith("bench/configs/")
        assert c["reduced"] == []
        assert cfg["max_features"] == cfg["graph"]["n_features"]
        assert cfg["model"]["hidden"] == [256, 128] and cfg["graph"]["scale"] == 1


def test_new_entries_are_found_from_files(tmp_path):
    root = benchutil.toy_root(tmp_path)
    (root / "bench/metrics/toy_counter.py").write_text(
        "def read(run):\n    return float(run.rounds)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "toy_counter", "unit": "rounds", "better": "higher",
                               "source": "program_counter", "layer": "whole round",
                               "moves": "step_ms", "workloads": [benchutil.TOY_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = cli.Spec(root)
    w = spec.workload(benchutil.TOY_CELL)
    assert spec.config(w["config"])["graph"]["n_nodes"] == 600
    assert spec.traffic(w["traffic"])["cohort"] == 2
    assert spec.limits(benchutil.TOY_CELL)["age"] == 0
    assert [m["name"] for m in spec.per_layer(benchutil.TOY_CELL)][-1] == "toy_counter"

    class Run:
        rounds = 7
    assert spec.reader("toy_counter")(Run) == 7.0
