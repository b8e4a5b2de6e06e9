"""BENCHMARK.json against the contract's shapes, and every cell, mix,
configuration, limit and metric found by its file name."""

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
M = harness.manifest()


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in M["paths"])
    assert len(M["command"]) <= 32
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_and_units():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind, e["name"]))
    for kind in ("end_to_end", "per_layer"):
        for m in M[kind]:
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_metric_entries():
    e2e = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in e2e
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.0 < m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    """Each cell's configuration, traffic, driver, limits and metrics load
    from the files their names point to, and the cell reports setup_s, an
    end-to-end metric more and a per-layer metric."""
    assert harness.config(w["config"])
    mix = harness.traffic(w["traffic"])
    run_cls = harness.driver(mix["driver"]).Run
    assert callable(run_cls)
    assert (harness.HERE / "limits" / f"{w['name']}.json").exists()
    e2e = harness.cell_metrics(w["name"], "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    per = harness.cell_metrics(w["name"], "per_layer")
    assert per
    for m in e2e + per:
        assert callable(harness.metric_reader(m["name"]))
        for cell in m.get("workloads", []):
            assert cell in {x["name"] for x in M["workloads"]}


def test_configs_files_distinct_and_under_paths():
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["file"].startswith("portbench/")
        assert len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200
