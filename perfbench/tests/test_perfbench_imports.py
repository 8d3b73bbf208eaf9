"""The import check, and the harness's refusals without a card or the
program."""

import json
import shutil
import subprocess
import sys

from perfbench.manifest import HERE
from perfbench.run import forbidden_modules


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["yolo_for_turbines_tpu_torch", "yolo_for_turbines_tpu_torch.ops",
                              "jax_like", "jaxlibx", "numpy"]) == []
    assert forbidden_modules(["yolo_for_turbines_tpu", "yolo_for_turbines_tpu.models", "jax",
                              "jaxlib.xla", "flax.linen"]) == [
        "flax.linen", "jax", "jaxlib.xla", "yolo_for_turbines_tpu", "yolo_for_turbines_tpu.models"]


def test_a_cpu_run_loads_no_jax(tiny_bench):
    """A whole tiny run in a fresh process, then the check."""
    code = f"""
import sys, time
from perfbench.manifest import Bench
from perfbench import run
from pathlib import Path
b = Bench.load(Path({str(tiny_bench.root)!r}) / "BENCHMARK.json")
b.here = Path({str(tiny_bench.here)!r})
for w in b.data["workloads"]:
    run.run_cell(b, w, 3, 0.2, False, "cpu", time.perf_counter(), emit=lambda l: None)
print(run.forbidden_modules(), "yolo_for_turbines_tpu_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(HERE.parent), timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def _run(cwd, *args):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "coco416-offline-bf16", "--seed", "3", "--seconds", "1", *args],
                          capture_output=True, text=True, cwd=str(cwd), timeout=300)


def test_no_card_no_result():
    out = _run(HERE.parent)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert not any(line.startswith("{") and '"correct"' in line
                   for line in out.stdout.splitlines())
    json.loads((tmp_path / "BENCHMARK.json").read_text())
