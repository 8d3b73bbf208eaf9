"""A benchmark of tiny cells for the CPU tests: the real harness, drivers,
readers and reference over a 64px, three-scale model of the same layer
list's shape, written into a directory of its own."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench.manifest import HERE, Bench

LAYERS = [[8, 3, 1], [16, 3, 2], [32, 3, 2], ["B", 8], [64, 3, 2], ["B", 8], [128, 3, 2],
          ["B", 1], [64, 1, 1], [128, 3, 1], "S", [32, 1, 1], "U", [32, 1, 1], [64, 3, 1],
          "S", [16, 1, 1], "U", [16, 1, 1], [32, 3, 1], "S"]


def config(name: str, activation: str) -> dict:
    real = json.loads((HERE / "configs" / "yolov3-turbines416.json").read_text())
    return {**real, "name": name, "layers": LAYERS, "num_classes": 3, "activation": activation,
            "strides": [16, 8, 4], "image_size": 64,
            "train": {**real["train"], "dtype": "float32"}}


MIXES = {
    "offline-tiny": {"kind": "offline", "batch": 4, "pool": 2, "calibration_images": 4,
                     "check_batches": 2, "check_within": 3, "trace_iterations": 4,
                     "warm_iterations": 1},
    "stream-tiny": {"kind": "stream", "sizes": [[40, 30], [64, 48], [96, 54]],
                    "images_per_size": 2, "check_requests": 3,
                    "check_within": 6, "trace_iterations": 6, "warm_iterations": 1},
    "train-tiny": {"kind": "train_step", "batch": 4, "pool": 4, "boxes_per_image": [1, 4],
                   "box_center": [0.2, 0.8], "box_size": [0.05, 0.5], "check_steps": 3,
                   "warm_steps": 1, "trace_iterations": 3},
}

CELLS = {"offline": ("tiny-leaky", "offline-tiny"), "stream": ("tiny-mish", "stream-tiny"),
         "train": ("tiny-mish", "train-tiny")}


def bench(tmp: Path) -> Bench:
    """The real BENCHMARK.json's metrics and limits over tiny cells, in
    ``tmp``."""
    real = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    here = tmp / "pb"
    shutil.copytree(HERE / "metrics", here / "metrics")
    (here / "traffic").mkdir()
    (here / "limits").mkdir()
    for name, mix in MIXES.items():
        (here / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    configs = []
    for name, act in (("tiny-leaky", "leaky_relu"), ("tiny-mish", "mish")):
        (tmp / f"{name}.json").write_text(json.dumps(config(name, act)))
        configs.append({"name": name, "source": "tests", "file": f"{name}.json", "reduced": [],
                        "why": "tiny"})
    # the real cells' names, found by their mix's first word
    real_cells = {w["traffic"].split("-")[0]: w["name"] for w in real["workloads"]}
    workloads = []
    for kind, (cfg, mix) in CELLS.items():
        name = real_cells[kind]
        workloads.append({"name": name, "config": cfg, "traffic": mix, "chips": 1, "why": "tiny"})
        shutil.copy(HERE / "limits" / f"{name}.json", here / "limits" / f"{name}.json")
    data = {**real, "configs": configs, "workloads": workloads}
    (tmp / "BENCHMARK.json").write_text(json.dumps(data))
    return Bench(data, tmp, here)
