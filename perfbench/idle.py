"""The quiet traced window's idle device time, put down to the program's
phases.

The quiet trace (``run.quiet``) records the device's work and the runtime
calls that launched it; the only record of the program's phases there is
its span log (``utils/profiling.py::spans``). Each logged span carries its
open and close on the profiler's Unix clock (``u0``, ``u1``, microseconds).
A trace's ``ts`` is that clock less the trace's base, which the profiler
takes once for the process, so one base serves both traces of a run.

- :func:`fit` finds the base where the same spans are both log entries and
  ``record_function`` ranges: in the host-traced window (``run.trace``).
  It pairs them name by name in order. A span's stamps are taken just
  outside its range's own, and the profiler stamps a range's close last in
  its exit, so a span's close offset (``u1`` less its range's end) is the
  base plus a few microseconds, more where the thread was held up between
  the two stamps. The base is the smallest close offset. The spread is the
  largest less the smallest of the lowest close offsets of consecutive
  groups of :data:`GROUP` pairs: a thread held up now and then leaves each
  group's lowest offset where it is, a clock that drifts from the trace's
  moves it.
- :func:`idle_by_phase` maps the quiet window (the first call's start to the
  last call's end) and its spans onto the quiet trace's clock with the
  base, and takes the idle time: the window less the union of the
  device's kernels, copies and memsets. Each idle gap goes whole to the phase that
  launched the op that ends it: the phase open on the calling thread at
  that op's launch (the runtime call of the same correlation id, which the
  quiet trace records on the host's clock). So a bubble between queued
  kernels counts to the phase that queued them, even while the caller
  waits on its fetch, and the time the host takes to reach a launch counts
  to the phase that makes it. A phase is a child of a root span; it holds
  the time from the close of the phase before it (or the root's open) to
  its own close, and the last phase holds the rest of its root. A launch
  outside every root counts to :data:`OUTSIDE`, and so does a gap that no
  op with a launch in the trace ends (the window's last). No label sets a
  device time against a host time, as only the window's two ends do: the
  device's clock in a CUDA-only trace can stand a few milliseconds off
  its host's.

Both give nothing (``None``) when the program logged no span with the
clock's stamps (a program without them, or no profiler), or when the fit's
spread is over :data:`SPREAD_US`. :func:`idle_by_phase` gives nothing also
when the mapped spans do not nest in order (roots that overlap, a phase
that closes before the one before it), or when their roots do not enclose
the launches their ranges enclose in the host-traced window
(:func:`_enclosed`): a broken clock shows as a missing number, not a
wrong one. Every idle microsecond of the window goes to one phase or to
:data:`OUTSIDE`, so the readers of a run add up to its quiet idle.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import clip, union

SPREAD_US = 50.0
GROUP = 8
LAUNCHES = 0.01
OUTSIDE = "outside"


def _stamped(logged) -> list:
    return [s for s in logged if getattr(s, "u0", None) is not None]


def fit(trace, logged: Sequence) -> Optional[Tuple[float, float]]:
    """(base, spread) in microseconds, so that a logged stamp ``u`` lies at
    ``u - base`` on ``trace``'s ``ts`` clock, from the spans of ``logged``
    paired with ``trace``'s ranges of the same name, in order (a name whose
    counts differ is left out); None when nothing pairs."""
    by_name: Dict[str, list] = defaultdict(list)
    for s in _stamped(logged):
        by_name[s.name].append(s)
    pairs = []
    for name, got in by_name.items():
        ranges = trace.ranges.get(name, [])
        if len(ranges) != len(got):
            continue
        got.sort(key=lambda s: s.u0)
        pairs += [(s.u1, s.u1 - 1e6 * b) for s, (_, b) in zip(got, ranges)]
    if not pairs:
        return None
    closes = [c for _, c in sorted(pairs)]
    lows = [min(closes[i:i + GROUP]) for i in range(0, len(closes), GROUP)]
    return min(closes), max(lows) - min(lows)


def _idle(device: List[dict], lo: float, hi: float) -> List[Tuple[float, float]]:
    """[lo, hi] less the union of the device events' intervals (microseconds)."""
    busy = clip(union([(e["ts"], e["ts"] + e.get("dur", 0)) for e in device]), lo, hi)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def _phases(roots, children, base: float) -> Optional[List[Tuple[float, float, str]]]:
    """(start, end, phase) on the trace's clock, in order; None unless each
    starts where the one before it ends, or later, and ends no earlier than
    it starts (roots that overlap, a phase that closes before the one
    before it)."""
    out = []
    for r in roots:
        start = r.u0 - base
        kids = sorted(children.get(r.id, ()), key=lambda s: s.u0)
        for k in kids:
            out.append((start, k.u1 - base, k.name))
            start = k.u1 - base
        out.append((start, r.u1 - base, kids[-1].name if kids else r.name))
    ends = [float("-inf")] + [b for _, b, _ in out]
    if any(a < end or b < a for (a, b, _), end in zip(out, ends)):
        return None
    return out


def _launches(quiet) -> Dict[float, float]:
    """{a device op's start: the earliest launch of an op starting then}, in
    microseconds on the quiet trace's clock."""
    out: Dict[float, float] = {}
    for e in quiet.device:
        at = quiet.launch_ts.get(id(e))
        if at is not None:
            out[e["ts"]] = min(out.get(e["ts"], float("inf")), 1e6 * at)
    return out


def _enclosed(run, root: str, roots, base: float) -> bool:
    """Whether the ``root`` spans laid on the quiet trace enclose as many
    device ops' launches per call as their ranges enclose in the
    host-traced window, within :data:`LAUNCHES`. The program launches the
    same ops in every call, so spans that land off the quiet trace's host
    clock enclose others."""
    held = run.trace.count(root)
    if not held:
        return False
    want = len(run.trace.events(inside=root)) / held
    mapped = sorted((r.u0 - base, r.u1 - base) for r in roots)
    starts = [a for a, _ in mapped]
    got = 0
    for e in run.quiet.device:
        at = run.quiet.launch_ts.get(id(e))
        if at is not None:
            i = bisect.bisect_right(starts, 1e6 * at) - 1
            got += i >= 0 and 1e6 * at <= mapped[i][1]
    return abs(got / len(roots) - want) <= LAUNCHES * want


def _where(t: float, phases, starts) -> str:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t <= phases[i][1]:
        return phases[i][2]
    return OUTSIDE


def idle_by_phase(run, root: str, logged: Optional[Sequence] = None):
    """({phase or ``OUTSIDE``: idle microseconds}, roots) over the quiet
    window of ``run``, whose calls open the root spans named ``root``;
    ``logged`` is the span log (the program's, when None). None when the
    run was not traced, logged no stamped ``root`` in the quiet window, or
    the fit fails or the spans do not fit the quiet trace (see the
    module)."""
    if run.trace is None or run.quiet is None or not run.records:
        return None
    if logged is None:
        from yolo_for_turbines_tpu_torch.utils import profiling

        logged = profiling.spans()
    lo, hi = run.records[0][0], run.records[-1][1]
    stamped = _stamped(logged)
    quiet = [s for s in stamped if lo <= s.t0 <= hi]
    roots = sorted((s for s in quiet if s.name == root and s.parent is None),
                   key=lambda s: s.u0)
    if not roots:
        return None
    ids = {r.id for r in roots}
    children: Dict[int, list] = defaultdict(list)
    for s in quiet:
        if s.parent in ids:
            children[s.parent].append(s)
    names = {root} | {s.name for kids in children.values() for s in kids}
    got = fit(run.trace, [s for s in stamped if s.t0 > hi and s.name in names])
    if got is None or got[1] > SPREAD_US:
        return None
    base = got[0]
    phases = _phases(roots, children, base)
    if phases is None or not _enclosed(run, root, roots, base):
        return None
    # perf_counter seconds -> the profiler's Unix microseconds
    shift = statistics.median(s.u0 - 1e6 * s.t0 for s in quiet)
    idle = _idle(run.quiet.device, 1e6 * lo + shift - base, 1e6 * hi + shift - base)
    starts = [a for a, _, _ in phases]
    launch = _launches(run.quiet)
    by_phase: Dict[str, float] = defaultdict(float)
    for a, b in idle:
        t = launch.get(b)
        by_phase[OUTSIDE if t is None else _where(t, phases, starts)] += b - a
    return dict(by_phase), len(roots)


def per_call_ms(run, root: str, phase: str) -> Optional[float]:
    """Idle milliseconds per call in ``phase`` (a child span's name, or
    ``OUTSIDE``) of the calls that open ``root``."""
    got = idle_by_phase(run, root)
    if got is None:
        return None
    by_phase, calls = got
    return 1e-3 * by_phase.get(phase, 0.0) / calls
