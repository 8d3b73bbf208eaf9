"""Spans and the device trace of a ``--trace 1`` run.

Spans come from the benchmark's own code, in three forms:

- :func:`module_spans`: forward hooks that open a
  ``torch.profiler.record_function`` range around a module's forward
  (``name(module, input)`` names it);
- :func:`wrap_call`: a range around a callable attribute of an object (the
  ``Trainer.train_step`` instance attribute);
- :func:`span`: a range around a call the harness makes itself.

:class:`Trace` reads the profiler's Chrome trace. Device work is every
kernel, memcpy and memset; its busy time is the union of their intervals.
A device event belongs to a span when the host call that launched it (the
runtime or driver call of the same correlation id) started inside that
span's range.

A traced run profiles two windows of the same calls: a quiet one with the
device's activity alone, whose busy time and idle share are the device's
(recording every host op costs the host some microseconds each, which
turns a step of a few thousand ops host-bound), and one with the host's ops
and the spans, for what each span launched and for the host's side of the
idle gaps.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def span(name: str):
    return torch.profiler.record_function(name)


def module_spans(modules: Sequence[torch.nn.Module], name: Callable) -> List:
    """Hooks on each module that open a range named ``name(module, input)``
    before its forward and close it after; returns the handles."""
    handles = []
    for m in modules:
        stack: List = []

        def pre(mod, args, stack=stack):
            rf = torch.profiler.record_function(name(mod, args[0]))
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, out, stack=stack):
            stack.pop().__exit__(None, None, None)

        handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    return handles


def wrap_call(obj, attr: str, name: str) -> None:
    """Replace ``obj.attr`` by a call of it inside a range ``name``."""
    inner = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return inner(*args, **kwargs)

    setattr(obj, attr, wrapped)


@contextlib.contextmanager
def profile(host: bool = True):
    """Yields a holder whose ``trace`` is the :class:`Trace` of the block,
    once it has ended; ``host=False`` records the device's activity alone,
    and the holder's ``seconds`` (set by the caller) is then the window."""
    holder = type("Held", (), {"trace": None, "seconds": None})()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host or not torch.cuda.is_available():  # a CPU run has only the host to record
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        yield holder
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.trace = Trace(json.load(f)["traceEvents"], holder.seconds)
    finally:
        os.unlink(path)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def total(intervals) -> float:
    return sum(b - a for a, b in intervals)


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


class Trace:
    """Times in seconds on the trace's clock. The window is the span
    ``perfbench.window``; a trace without spans covers its window whole,
    whose length on the host clock is ``seconds``."""

    def __init__(self, events: List[dict], seconds: Optional[float] = None):
        self.seconds = seconds
        xs = [e for e in events if e.get("ph") == "X"]
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS]
        launch = {}
        for e in xs:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launch[e["args"]["correlation"]] = e
        self.launch_ts = {}
        self.unlinked = 0
        for e in self.device:
            c = e.get("args", {}).get("correlation")
            if c in launch:
                self.launch_ts[id(e)] = launch[c]["ts"] * 1e-6
            else:
                self.unlinked += 1
        self.ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.host: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
        for e in xs:
            cat = e.get("cat")
            if cat == "user_annotation":
                self.ranges[e["name"]].append((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6))
            if cat in ("user_annotation", "cpu_op"):
                self.host[e.get("tid")].append(
                    (e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"]))
        for r in self.ranges.values():
            r.sort()

    @staticmethod
    def _interval(e) -> Tuple[float, float]:
        return e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6

    def window(self, name: str = "perfbench.window") -> Tuple[float, float]:
        if name not in self.ranges:
            return float("-inf"), float("inf")
        (lo, hi), = self.ranges[name]
        return lo, hi

    def count(self, name: str) -> int:
        return len(self.ranges.get(name, ()))

    def _inside(self, ts: float, name: str) -> bool:
        r = self.ranges.get(name, [])
        i = bisect.bisect_right(r, (ts, float("inf"))) - 1
        # ranges of one name do not nest, so the latest start is the one
        return i >= 0 and r[i][0] <= ts <= r[i][1]

    def events(self, inside: Optional[str] = None, outside: Optional[str] = None) -> List[dict]:
        """Device events launched inside range ``inside`` (any, when None) and
        not inside ``outside``, within the window."""
        lo, hi = self.window()
        out = []
        for e in self.device:
            a, b = self._interval(e)
            if b <= lo or a >= hi:
                continue
            ts = self.launch_ts.get(id(e))
            if inside is not None and (ts is None or not self._inside(ts, inside)):
                continue
            if outside is not None and ts is not None and self._inside(ts, outside):
                continue
            out.append(e)
        return out

    def busy_s(self, inside: Optional[str] = None, outside: Optional[str] = None) -> float:
        lo, hi = self.window()
        return total(clip(union([self._interval(e) for e in self.events(inside, outside)]),
                          lo, hi))

    def window_s(self) -> float:
        if self.seconds is not None:
            return self.seconds
        lo, hi = self.window()
        return hi - lo

    def device_ops(self, top: int = 10):
        by_name: Dict[str, float] = defaultdict(float)
        for e in self.events():
            a, b = self._interval(e)
            by_name[e["name"][:160]] += b - a
        return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        """Idle time between device intervals in the window, summed by the
        innermost host range or op running where each gap starts, on the
        thread that ran the window."""
        lo, hi = self.window()
        busy = clip(union([self._interval(e) for e in self.events()]), lo, hi)
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        tid = next(t for t, spans in self.host.items()
                   if any(n == "perfbench.window" for _, _, n in spans))
        spans = sorted(self.host[tid])
        starts = [s[0] for s in spans]
        by_label: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            label = "perfbench.window (no op)"
            best = None
            for s in spans[: bisect.bisect_right(starts, a)][::-1][:64]:
                if s[0] <= a < s[1] and (best is None or s[0] >= best[0]):
                    best = s
            if best is not None:
                label = best[2][:160]
            by_label[label] += b - a
        return sorted(([k, v] for k, v in by_label.items()), key=lambda kv: -kv[1])[:top]
