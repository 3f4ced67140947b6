"""BENCHMARK.json, the configurations and the traffic files load, keep
to the benchmark's contract, and name files that exist."""

import json
import re

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_keys(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert m["source"] in SOURCES
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


@pytest.mark.parametrize("workload", ["scam.grid4096", "digit.b1024"])
def test_cell_files_load(bench, workload):
    c = spec.cell(bench, workload)
    cfg = spec.config(bench, c["config"])
    traffic = spec.traffic(c["traffic"])
    assert traffic["loop"] == "closed" and traffic["in_flight"] == 1
    for kind, name in (("drivers", cfg["entry"]), ("clients", cfg["client"]),
                       ("reference", cfg["name"])):
        assert spec.module(kind, name) is not None
    e2e, layer = spec.cell_metrics(bench, workload)
    assert {"setup_s", "inferences_per_s", "batch_p95_ms"} <= {
        m["name"] for m in e2e}
    assert layer
    for m in e2e + layer:
        assert hasattr(spec.module("metrics", m["name"]), "read")
        for cell_name in m.get("workloads", []):
            spec.cell(bench, cell_name)
    assert set(cfg["check"]) and all(
        0 < c["limit"] for c in cfg["check"].values())


def test_digit_program_is_the_published_width(bench):
    cfg = spec.config(bench, "digit_recognition")
    assert len(cfg["params"]) == 10 * 784 == cfg["model"]["classes"] * \
        cfg["model"]["pixels"]
    assert cfg["params"][:2] == ["e0_0", "e0_1"]
    assert cfg["params"][-1] == "e9_783"


def test_scam_lists_the_walk_products(bench):
    cfg = spec.config(bench, "scam_example")
    products = cfg["k1"]["products"]
    assert len(products) == cfg["limit"] == 26
    largest = max(products, key=lambda p: p["a"][0] * p["a"][1])
    assert (largest["a"], largest["b"], largest["out"]) == (
        [27, 27], [2, 2], [27, 28])
