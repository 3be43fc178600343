"""The harness finds every configuration, traffic mix, reader and
reference by the names ``BENCHMARK.json`` gives."""

import json
import re

import pytest

from streambench import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_resolves(cell):
    res = harness.resolve(cell, SPEC)
    assert res["config"]["name"] == res["cell"]["config"]
    assert res["traffic"]["name"] == res["cell"]["traffic"]
    assert harness.reference_module(res["config"]["reference"]).make
    assert {m["name"] for m in res["end_to_end"]} >= {"setup_s"}
    assert len(res["end_to_end"]) >= 2 and res["per_layer"]
    for m in res["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_every_metric_has_a_reader_and_moves_an_end_to_end_metric():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert callable(harness.reader(m["name"]))


def test_names_and_files():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        with open(harness.ROOT / c["file"]) as f:
            assert json.load(f)["name"] == c["name"]
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")


def test_unknown_workload_is_refused():
    with pytest.raises(harness.RunError):
        harness.resolve("no-such.cell", SPEC)


def test_a_cell_resolves_its_own_metrics():
    spec = json.loads(json.dumps(SPEC))
    spec["per_layer"].append({"name": "queue_send_ms", "unit": "ms",
                              "better": "lower", "source": "program_span",
                              "layer": "wire edge", "moves": "served_fps",
                              "workloads": ["another.cell"]})
    cell = SPEC["workloads"][0]["name"]
    names = [m["name"] for m in harness.resolve(cell, spec)["per_layer"]]
    assert names.count("queue_send_ms") == 1
