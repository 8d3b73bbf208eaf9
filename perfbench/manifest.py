"""``BENCHMARK.json`` and the files it names, found by name:

- a configuration's file is the ``file`` of its entry (``configs/<name>.json``);
- a traffic mix is ``traffic/<traffic>.json``, whose ``kind`` names its
  driver, ``drivers/<kind>.py``;
- a metric is read by ``metrics/<name>.py``;
- a cell's limits on the numbers compared with the reference are
  ``limits/<workload>.json``.

:func:`problems` checks a manifest against the benchmark's rules that a run
can see (names, units, which cells report which metric).
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


class Bench:
    def __init__(self, data: dict, root: Path, here: Path = HERE):
        self.data, self.root, self.here = data, Path(root), Path(here)

    @classmethod
    def load(cls, path) -> "Bench":
        path = Path(path)
        return cls(json.loads(path.read_text()), path.parent)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == cell["config"])
        return json.loads((self.root / entry["file"]).read_text())

    def mix(self, cell: dict) -> dict:
        return json.loads((self.here / "traffic" / f"{cell['traffic']}.json").read_text())

    def limits(self, cell: dict) -> dict:
        return json.loads((self.here / "limits" / f"{cell['name']}.json").read_text())

    def metrics(self, cell: dict, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.data[kind] if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, name: str):
        """``read(run)`` of ``metrics/<name>.py``."""
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{re.sub(r'[^A-Za-z0-9_]', '_', name)}",
            self.here / "metrics" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def problems(bench: Bench) -> List[str]:
    """What breaks the rules, as sentences; empty when nothing does."""
    d = bench.data
    out = []
    cells = {w["name"]: w for w in d["workloads"]}
    e2e = {m["name"]: m for m in d["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in d[k]]
    for n in names:
        if not NAME.match(n):
            out.append(f"name {n!r} has a character outside the rule or is too long")
    if len(set(m["name"] for k in ("end_to_end", "per_layer") for m in d[k])) != \
            len(d["end_to_end"]) + len(d["per_layer"]):
        out.append("two metrics share a name")
    for m in d["end_to_end"] + d["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: unit {m['unit']!r} breaks the rule")
        if m["better"] not in ("lower", "higher") or m["source"] not in SOURCES:
            out.append(f"{m['name']}: better or source out of range")
        for w in m.get("workloads", []):
            if w not in cells:
                out.append(f"{m['name']}: no cell {w!r}")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in d["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"{m['name']}: an end-to-end metric is host_clock or device_trace")
        if not 0 < m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound out of (0, 0.25]")
    for m in d["per_layer"]:
        moves = e2e.get(m["moves"])
        if moves is None:
            out.append(f"{m['name']}: moves {m['moves']!r}, which is no end-to-end metric")
            continue
        for w in m.get("workloads", list(cells)):
            if w not in moves.get("workloads", list(cells)):
                out.append(f"{m['name']}: cell {w} does not report {m['moves']}")
    for w in cells:
        cell = cells[w]
        mine = [m["name"] for m in bench.metrics(cell, "end_to_end")]
        if "setup_s" not in mine or len(mine) < 2:
            out.append(f"{w}: reports setup_s and at least one other end-to-end metric")
        if not bench.metrics(cell, "per_layer"):
            out.append(f"{w}: reports no per-layer metric")
        for m in bench.metrics(cell, "end_to_end") + bench.metrics(cell, "per_layer"):
            if not (bench.here / "metrics" / f"{m['name']}.py").exists():
                out.append(f"{m['name']}: no reader metrics/{m['name']}.py")
        if not (bench.here / "traffic" / f"{cell['traffic']}.json").exists():
            out.append(f"{w}: no traffic/{cell['traffic']}.json")
        if not (bench.here / "limits" / f"{w}.json").exists():
            out.append(f"{w}: no limits/{w}.json")
        if cell["chips"] not in (1, 4):
            out.append(f"{w}: chips is 1 or 4")
    pairs = [(w["config"], w["traffic"]) for w in d["workloads"]]
    if len(set(pairs)) != len(pairs):
        out.append("a pair of configuration and traffic appears twice")
    return out
