"""BENCHMARK.json against the contract's shape, and every configuration,
traffic mix, driver and metric found by its name."""

import importlib
import json
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.load_bench()
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_whys():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        group = [e["name"] for e in BENCH[key]]
        assert len(group) == len(set(group)), key
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.cell_of(BENCH, cell)
    assert c["chips"] == 1
    assert c["config"] in {x["name"] for x in BENCH["configs"]}
    config = harness.load_config(c["config"])
    traffic = harness.load_traffic(c["traffic"])
    importlib.import_module(f"benchmark.drivers.{traffic['driver']}").Driver
    importlib.import_module(f"benchmark.reference.{config['reference']}").World
    reported = [m["name"] for m in BENCH["end_to_end"] if harness.applies(m, cell)]
    assert "setup_s" in reported and len(reported) >= 2
    layer = harness.metric_modules(BENCH, cell)
    assert layer and all(hasattr(mod, "read") and isinstance(mod.SPANS, dict)
                         for _, mod in layer)
    e2e = {m["name"] for m in BENCH["end_to_end"] if harness.applies(m, cell)}
    for m in BENCH["per_layer"]:
        if harness.applies(m, cell):
            assert m["moves"] in e2e


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert config["file"] == f"benchmark/configs/{config['name']}.json"
    data = harness.load_config(config["name"])
    assert data["source"] == config["source"]
    assert data["precision"] == data["env"]["dtype"] == "float32"
    assert all(NAME.match(k) for k in config["reduced"])


def test_every_file_is_used():
    here = os.path.join(harness.BENCH_DIR)
    configs = {os.path.splitext(f)[0] for f in os.listdir(os.path.join(here, "configs"))}
    assert configs == {c["name"] for c in BENCH["configs"]}
    traffic = {os.path.splitext(f)[0] for f in os.listdir(os.path.join(here, "traffic"))}
    assert traffic == {c["traffic"] for c in BENCH["workloads"]}
    metrics = {os.path.splitext(f)[0] for f in os.listdir(os.path.join(here, "metrics"))
               if f.endswith(".py") and f != "__init__.py"}
    assert metrics == {m["name"] for m in BENCH["per_layer"]}
