"""The benchmark's idle and letterbox readers (``perfbench/idle.py``,
``perfbench/metrics/{offline,train}.idle_*_ms.py`` and
``stream.{resize,pad,scale}_ms.py``): exact sums on hand-built traces and
span logs, nothing without the clock's stamps or with a broken clock, and
the eleven readers on tiny traced runs on the CPU."""

import time
from types import SimpleNamespace

import pytest

from perfbench import idle, run
from perfbench.manifest import Bench
from perfbench.trace import Trace
from yolo_for_turbines_tpu_torch.utils import profiling

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BASE = 1_700_000_000_000_000.0  # the trace's base on the profiler's Unix clock, us
SHIFT = 1_790_000_000_000_000.0  # Unix us less perf_counter us
CALL_US = 1000.0

OFFLINE = ("predict_batch", ("predict_batch.input", "predict_batch.forward",
                             "predict_batch.postprocess"))
TRAIN = ("train_step", ("train_step.forward", "train_step.backward", "train_step.optimizer"))
READERS = {
    "offline": {OFFLINE[1][0]: "offline.idle_input_ms", OFFLINE[1][1]: "offline.idle_forward_ms",
                OFFLINE[1][2]: "offline.idle_postproc_ms",
                idle.OUTSIDE: "offline.idle_outside_ms"},
    "train": {TRAIN[1][0]: "train.idle_forward_ms", TRAIN[1][1]: "train.idle_backward_ms",
              TRAIN[1][2]: "train.idle_optimizer_ms", idle.OUTSIDE: "train.idle_outside_ms"},
}

# one call, in us from its start on the profiler's Unix clock: the root,
# its three phases, and the device's busy intervals
ROOT_US = (10.0, 900.0)
PHASES_US = ((20.0, 100.0), (110.0, 700.0), (710.0, 880.0))
BUSY_US = ((50.0, 90.0), (150.0, 650.0), (720.0, 860.0), (905.0, 950.0))
# idle [0,50] [90,150] [650,720] [860,905] [950,1000]; the busy intervals'
# ops launched at these times, so that each gap goes to the phase of the
# launch that ends it: a call's tail [950,1000] with the next call's
# [0,50] to the first phase, [90,150] to the second, [650,720] to the
# third (launched between the second's close and the third's), [860,905]
# outside (launched after the root's close); the first call's [0,50] to
# its first phase, the last call's tail, which no op ends, outside
LAUNCH_US = (30.0, 120.0, 705.0, 902.0)


def _want(names, calls):
    """Idle us by phase over ``calls`` calls."""
    return dict(zip(names[1], (100.0 * calls - 50.0, 60.0 * calls, 70.0 * calls)),
                **{idle.OUTSIDE: 45.0 * calls + 50.0})


class _Span(SimpleNamespace):
    pass


def _spans(names, start_us, calls, first_id):
    """The log of ``calls`` calls from ``start_us`` (Unix us), each a root
    and its three phases at ``ROOT_US`` / ``PHASES_US``."""
    root, phases = names
    out, ids = [], first_id
    for k in range(calls):
        at = start_us + k * CALL_US
        r = _Span(name=root, id=ids, parent=None, u0=at + ROOT_US[0], u1=at + ROOT_US[1])
        out.append(r)
        for name, (a, b) in zip(phases, PHASES_US):
            ids += 1
            out.append(_Span(name=name, id=ids, parent=r.id, u0=at + a, u1=at + b))
        ids += 1
    for s in out:
        s.t0, s.t1 = (s.u0 - SHIFT) * 1e-6, (s.u1 - SHIFT) * 1e-6
    return out


def _ranges(logged, late_us, early_us, drift_us):
    """``record_function`` events of the logged spans on the trace's clock:
    the i-th opens ``late_us(i)`` after its span's open and closes
    ``early_us(i)`` before its close, both ends moved a further
    ``drift_us(i)``."""
    return [{"ph": "X", "cat": "user_annotation", "name": s.name,
             "ts": s.u0 - BASE + late_us(i) + drift_us(i),
             "dur": (s.u1 - s.u0) - late_us(i) - early_us(i), "tid": 1}
            for i, s in enumerate(logged)]


def _device(start, calls, launched, first):
    """The device's ops at ``BUSY_US`` in ``calls`` calls from ``start``
    (Unix us), each launched at ``LAUNCH_US`` when ``launched``
    (correlation ids from ``first``)."""
    out = []
    for k in range(calls):
        for (a, b), at in zip(BUSY_US, LAUNCH_US):
            op = {"ph": "X", "cat": "kernel", "name": "k", "ts": start + k * CALL_US + a - BASE,
                  "dur": b - a}
            out.append(op)
            if launched:
                op["args"] = {"correlation": first + len(out)}
                out.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                            "ts": start + k * CALL_US + at - BASE, "dur": 1.0,
                            "args": dict(op["args"])})
    return out


def _run(names=OFFLINE, calls=3, late_us=lambda i: 0.0, early_us=lambda i: 0.0,
         drift_us=lambda i: 0.0, stamped=True, launched=True):
    """(run, log): a traced run whose quiet window holds ``calls`` calls,
    the device busy at ``BUSY_US`` in each (and once before and after the
    window), each op launched at ``LAUNCH_US`` when ``launched``, and
    whose host-traced window repeats the calls later, ops and launches
    too, with their ranges (``_ranges``)."""
    start = SHIFT + 100e6
    quiet = _spans(names, start, calls, 1)
    held = _spans(names, start + 1e6, calls, 1000)
    ranges = _ranges(held, late_us, early_us, drift_us)
    if not stamped:  # a program whose spans carry no trace-clock stamps
        for s in quiet + held:
            del s.u0, s.u1
    device = _device(start, calls, launched, 0)
    device += [{"ph": "X", "cat": "kernel", "name": "k", "ts": start - 500.0 - BASE, "dur": 400.0},
               {"ph": "X", "cat": "gpu_memcpy", "name": "c",
                "ts": start + calls * CALL_US + 10.0 - BASE, "dur": 5.0}]
    records = [((start + k * CALL_US - SHIFT) * 1e-6,
                (start + (k + 1) * CALL_US - SHIFT) * 1e-6, 8) for k in range(calls)]
    r = run.Run({"name": "hand-built"}, {}, {}, records, calls * CALL_US * 1e-6, 0.0,
                Trace(ranges + _device(start + 1e6, calls, launched, 10**6)), Trace(device))
    return r, quiet + held


@pytest.mark.parametrize("launched", [True, False], ids=["launched", "unlinked"])
@pytest.mark.parametrize("calls", [1, 3])
@pytest.mark.parametrize("names", [OFFLINE, TRAIN], ids=["offline", "train"])
def test_known_gaps_sum_exactly_by_phase(names, calls, launched):
    """Each gap goes whole to the phase of the launch that ends it; a gap
    whose op has no launch in the trace, or that no op ends, outside."""
    r, logged = _run(names, calls, launched=launched)
    by_phase, roots = idle.idle_by_phase(r, names[0], logged)
    assert roots == calls
    idle_us = (CALL_US - sum(b - a for a, b in BUSY_US)) * calls
    want = _want(names, calls) if launched else {idle.OUTSIDE: idle_us}
    assert {k for k, v in want.items() if v} == by_phase.keys()
    for phase, us in want.items():
        assert by_phase.get(phase, 0.0) == pytest.approx(us, abs=1e-3), phase
    # every idle us of the window is put down somewhere, once
    assert sum(by_phase.values()) == pytest.approx(idle_us, abs=1e-3)


@pytest.mark.parametrize("kind", ["offline", "train"])
def test_the_readers_give_the_sums_per_call(monkeypatch, kind):
    names = OFFLINE if kind == "offline" else TRAIN
    r, logged = _run(names, calls=3)
    monkeypatch.setattr(profiling, "spans", lambda since=None, until=None: list(logged))
    bench = Bench.load(run.ROOT / "BENCHMARK.json")
    want = _want(names, 3)
    values = {}
    for phase, metric in READERS[kind].items():
        values[metric] = bench.reader(metric)(r)
        assert values[metric] == pytest.approx(want[phase] * 1e-3 / 3, abs=1e-9), metric
    assert sum(values.values()) == pytest.approx(sum(want.values()) * 1e-3 / 3, abs=1e-9)


def test_the_fit_finds_the_base_and_its_spread():
    r, logged = _run(late_us=lambda i: 5.0, early_us=lambda i: 1.0 + (i % 4))
    held = [s for s in logged if s.u0 > SHIFT + 100.5e6]
    # the earliest base that keeps every close after its range's end; the
    # stamps' jitter leaves each group's lowest close offset at 1 us
    assert idle.fit(r.trace, held) == pytest.approx((BASE + 1.0, 0.0), abs=1e-3)
    # a pair held up (its span 50 us wider than its range) says nothing of
    # the clock's spread
    r, logged = _run(late_us=lambda i: 20.0 if i == 5 else 5.0,
                     early_us=lambda i: 30.0 if i == 5 else 1.0 + (i % 4))
    held = [s for s in logged if s.u0 > SHIFT + 100.5e6]
    assert idle.fit(r.trace, held) == pytest.approx((BASE + 1.0, 0.0), abs=1e-3)
    # a clock that steps 10 us after the first two calls (the first group of
    # eight pairs)
    r, logged = _run(early_us=lambda i: 1.0 + (i % 4),
                     drift_us=lambda i: 10.0 if i >= 8 else 0.0)
    held = [s for s in logged if s.u0 > SHIFT + 100.5e6]
    assert idle.fit(r.trace, held) == pytest.approx((BASE - 9.0, 10.0), abs=1e-3)


@pytest.mark.parametrize("kind", ["offline", "train"])
@pytest.mark.parametrize("case", ["no_spans", "no_stamps", "spread", "untraced"])
def test_nothing_without_stamped_spans_or_with_a_broken_clock(monkeypatch, kind, case):
    """No span logged; spans without the trace clock's stamps (a program
    that has none); ranges that drift 138 us from their spans' stamps over
    the window's six calls (spread over 50 us, each pair tight); a run
    without traces."""
    names = OFFLINE if kind == "offline" else TRAIN
    r, logged = _run(names, calls=6, stamped=case != "no_stamps",
                     drift_us=(lambda i: 6.0 * i) if case == "spread" else (lambda i: 0.0))
    if case == "no_spans":
        logged = []
    if case == "untraced":
        r.trace = r.quiet = None
    if case == "spread":
        assert idle.fit(r.trace, logged[len(logged) // 2:])[1] > idle.SPREAD_US
    monkeypatch.setattr(profiling, "spans", lambda since=None, until=None: list(logged))
    bench = Bench.load(run.ROOT / "BENCHMARK.json")
    assert idle.idle_by_phase(r, names[0], logged) is None
    for metric in READERS[kind].values():
        assert bench.reader(metric)(r) is None, metric


@pytest.mark.parametrize("fault", ["roots_overlap", "phase_closes_early", "off_the_clock"])
def test_nothing_where_the_spans_do_not_fit_the_quiet_trace(fault):
    """Roots that overlap, a phase that closes before the one before it, or
    spans that land 400 us off the quiet trace's launches (their roots then
    enclose 10 launches over 3 calls against 3 a call in the host-traced
    window): the run gives nothing."""
    r, logged = _run(OFFLINE, calls=3)
    quiet = logged[:12]  # the quiet window's calls: a root and its phases each
    assert idle.idle_by_phase(r, OFFLINE[0], logged) is not None
    if fault == "roots_overlap":
        quiet[4].u0 -= 200.0  # the second call opens inside the first
    elif fault == "phase_closes_early":
        quiet[2].u1 = quiet[1].u1 - 50.0  # the first call's second phase
    else:
        for s in quiet:
            s.u0, s.u1 = s.u0 + 400.0, s.u1 + 400.0
    assert idle.idle_by_phase(r, OFFLINE[0], logged) is None


def test_the_letterbox_readers(monkeypatch):
    """Host ms per request of each part, over the ``predict_image`` roots in
    the window; nothing where the program logs no such span."""
    logged = []
    for k in range(4):
        at = 10.0 + k
        logged += [_Span(name="predict_image", t0=at, t1=at + 0.03),
                   _Span(name="predict_image.letterbox", t0=at + 0.001, t1=at + 0.011),
                   _Span(name="predict_image.resize", t0=at + 0.001, t1=at + 0.007),
                   _Span(name="predict_image.pad", t0=at + 0.007, t1=at + 0.009),
                   _Span(name="predict_image.scale", t0=at + 0.009, t1=at + 0.011)]

    def log(since=None, until=None):
        return [s for s in logged if since <= s.t0 <= until]

    monkeypatch.setattr(profiling, "spans", log)
    bench = Bench.load(run.ROOT / "BENCHMARK.json")
    r = run.Run({}, {}, {}, [(9.5, 13.5, 1)], 4.0, 0.0)
    got = {m: bench.reader(f"stream.{m}_ms")(r) for m in ("resize", "pad", "scale")}
    assert got == pytest.approx({"resize": 6.0, "pad": 2.0, "scale": 2.0})
    assert sum(got.values()) == pytest.approx(bench.reader("stream.letterbox_ms")(r))
    # a program without the parts (the letterbox in one span), no call, no log
    logged = [s for s in logged if s.name in ("predict_image", "predict_image.letterbox")]
    for m in ("resize", "pad", "scale"):
        assert bench.reader(f"stream.{m}_ms")(r) is None
        assert bench.reader(f"stream.{m}_ms")(run.Run({}, {}, {}, [], 0.0, 0.0)) is None


TINY = {"coco416-offline-bf16": ("offline", OFFLINE[0]),
        "turbines416-train-step": ("train", TRAIN[0]),
        "turbines416-stream-bf16": ("stream", None)}


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_readers_on_a_tiny_traced_run(tmp_path, monkeypatch, name):
    """The tiny cells through the harness on the CPU (``perfbench/tests/
    tiny.py``): the new metrics read a number; the idle ones add up to the
    quiet window over its calls (no device, so all of it is idle); the
    letterbox's parts to at most the letterbox."""
    from perfbench.tests import tiny

    bench = tiny.bench(tmp_path)
    runs = []

    class Kept(run.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runs.append(self)

    monkeypatch.setattr(run, "Run", Kept)
    result = run.run_cell(bench, bench.cell(name), 2**31 + 41, 10.0, True, "cpu",
                          time.perf_counter(), emit=lambda line: None)
    assert result["correct"], result["checks"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    kind, root = TINY[name]
    if kind == "stream":
        parts = [metrics[f"stream.{m}_ms"] for m in ("resize", "pad", "scale")]
        assert all(p > 0 for p in parts) and sum(parts) <= metrics["stream.letterbox_ms"]
        return
    readers = READERS[kind].values()
    assert all(metrics[m] >= 0 for m in readers)
    (kept,) = runs
    window_ms = 1e3 * (kept.records[-1][1] - kept.records[0][0]) / len(kept.records)
    # to a microsecond: the window's ends on the Unix clock round to 0.25 us
    assert sum(metrics[m] for m in readers) == pytest.approx(window_ms, abs=1e-3)
    by_phase, calls = idle.idle_by_phase(kept, root)
    assert calls == len(kept.records)
    _, spread = idle.fit(kept.trace, [s for s in profiling.spans()
                                      if s.t0 > kept.records[-1][1]])
    assert spread <= idle.SPREAD_US
