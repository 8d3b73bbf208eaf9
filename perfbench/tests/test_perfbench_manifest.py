"""BENCHMARK.json against the benchmark's rules, and a cell and a metric
added by files alone."""

import copy
import json
import shutil
import time

import pytest

from perfbench import run
from perfbench.manifest import HERE, Bench, problems


def real():
    return Bench.load(HERE.parent / "BENCHMARK.json")


def test_benchmark_json_keeps_the_rules():
    assert problems(real()) == []


def test_keys_and_limits_of_the_contract():
    d = real().data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert d["command"][1] == "perfbench/run.py" and d["paths"] == ["perfbench"]
    assert 1 <= d["run_seconds"] <= 51
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (HERE.parent / c["file"]).exists()
    setup = next(m for m in d["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


def test_every_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    b = real()
    for m in b.data["per_layer"]:
        for w in m["workloads"]:
            names = [e["name"] for e in b.metrics(b.cell(w), "end_to_end")]
            assert m["moves"] in names


@pytest.mark.parametrize("field,value", [
    ("name", "has space"), ("name", "x" * 65), ("name", "a/b"), ("unit", "images per s"),
    ("unit", "µs"), ("better", "up"), ("source", "guess"),
])
def test_a_name_or_unit_out_of_the_rule_is_found(field, value):
    b = real()
    data = copy.deepcopy(b.data)
    data["per_layer"][0][field] = value
    assert problems(Bench(data, b.root, b.here))


def test_a_metric_whose_cell_lacks_its_moves_is_found():
    b = real()
    data = copy.deepcopy(b.data)
    m = next(x for x in data["per_layer"] if x["moves"] == "train_img_per_s")
    m["workloads"] = ["coco416-offline-bf16"]
    assert any("does not report" in p for p in problems(Bench(data, b.root, b.here)))


def test_a_cell_and_a_metric_added_by_files_alone(tmp_path, tiny_bench):
    """A new mix file, a new limits file, a new reader and two new entries:
    the harness runs the new cell and reports the new metric, with no file
    of the benchmark changed."""
    here = tiny_bench.here
    mix = dict(json.loads((here / "traffic" / "offline-tiny.json").read_text()), batch=2)
    (here / "traffic" / "offline-tiny-b2.json").write_text(json.dumps(mix))
    shutil.copy(here / "limits" / "coco416-offline-bf16.json", here / "limits" / "tiny-b2.json")
    (here / "metrics" / "offline.calls.py").write_text(
        "def read(run):\n    return float(len(run.records))\n")
    data = copy.deepcopy(tiny_bench.data)
    data["workloads"].append({"name": "tiny-b2", "config": "tiny-leaky",
                              "traffic": "offline-tiny-b2", "chips": 1, "why": "added"})
    for m in data["end_to_end"]:
        if m["name"] == "offline_img_per_s":
            m["workloads"].append("tiny-b2")
    data["per_layer"].append({"name": "offline.calls", "unit": "calls", "better": "higher",
                              "source": "host_clock", "layer": "device",
                              "moves": "offline_img_per_s", "workloads": ["tiny-b2"]})
    bench = Bench(data, tiny_bench.root, here)
    assert problems(bench) == []
    cell = bench.cell("tiny-b2")
    result = run.run_cell(bench, cell, 2**31 + 5, 1.0, False, "cpu", time.perf_counter(),
                          emit=lambda line: None)
    assert result["correct"] and set(result["metrics"]) == {"offline_img_per_s", "setup_s"}
    traced = run.run_cell(bench, cell, 2**31 + 5, 1.0, True, "cpu", time.perf_counter(),
                          emit=lambda line: None)
    assert traced["metrics"]["offline.calls"]["value"] > 0
