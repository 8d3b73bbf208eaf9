"""Torch port: the program's spans (utils/profiling.py::span, spans) and
where the single-image path and the train step open them."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import idle
from perfbench.trace import Trace
from yolo_for_turbines_tpu_torch.config import ModelConfig, TrainConfig
from yolo_for_turbines_tpu_torch.data.augment import letterbox
from yolo_for_turbines_tpu_torch.inference import Predictor
from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan, init_plan
from yolo_for_turbines_tpu_torch.tools import profile_serving
from yolo_for_turbines_tpu_torch.utils import profiling
from yolo_for_turbines_tpu_torch.utils.profiling import span, spans

from helpers import MINI_LAYERS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PREDICT_IMAGE = ["predict_image", "predict_image.letterbox", "predict_image.resize",
                 "predict_image.pad", "predict_image.scale", "predict_batch",
                 "predict_batch.input", "predict_batch.forward", "predict_batch.postprocess",
                 "predict_image.fetch", "predict_image.unletterbox"]
PREDICT_BATCH = PREDICT_IMAGE[5:9]
PARENT = {"predict_image.letterbox": "predict_image", "predict_image.resize":
          "predict_image.letterbox", "predict_image.pad": "predict_image.letterbox",
          "predict_image.scale": "predict_image.letterbox", "predict_batch": "predict_image",
          "predict_batch.input": "predict_batch", "predict_batch.forward": "predict_batch",
          "predict_batch.postprocess": "predict_batch", "predict_image.fetch": "predict_image",
          "predict_image.unletterbox": "predict_image"}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _predictor(device="cpu"):
    cfg = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    tree = init_plan(build_plan(cfg), torch.Generator().manual_seed(0))
    return Predictor.from_folded(cfg, tree, device=device, image_size=64, max_boxes=8)


def _frame(h=48, w=80):
    return np.random.default_rng(0).integers(0, 256, (h, w, 3), dtype=np.uint8)


def test_without_a_profiler_a_span_is_one_check_and_logs_nothing(monkeypatch):
    checks = []
    real = torch.autograd._profiler_enabled

    def counted():
        checks.append(1)
        return real()

    def no_range(name):
        raise AssertionError("a range was opened with no profiler running")

    monkeypatch.setattr(torch.autograd, "_profiler_enabled", counted)
    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    before = len(profiling._log)
    t0 = time.perf_counter()
    first, second = span("a"), span("b")
    assert first is second and first is profiling._OFF
    with span("outer"):
        with span("inner"):
            pass
    assert len(checks) == 4
    assert len(profiling._log) == before and spans(since=t0) == []
    # the path's own spans are as quiet
    _predictor().predict_image(_frame())
    assert len(profiling._log) == before and spans(since=t0) == []


def _root(span, by_id):
    while span.parent is not None:
        span = by_id[span.parent]
    return span


def test_nested_spans_log_parent_and_request():
    """Each span names its parent; the spans of one request reach the same
    root through their parents, on both clocks in order."""
    t0 = time.perf_counter()
    with _cpu_profile():
        assert torch.autograd._profiler_enabled()
        for _ in range(2):
            with span("root"):
                with span("child"):
                    with span("grandchild"):
                        pass
                with span("sibling"):
                    pass
    got = spans(since=t0)
    assert [s.name for s in got] == ["root", "child", "grandchild", "sibling"] * 2
    by_id = {s.id: s for s in got}
    first, second = got[:4], got[4:]
    for root, child, grandchild, sibling in (first, second):
        assert root.parent is None
        assert child.parent == root.id and sibling.parent == root.id
        assert grandchild.parent == child.id
        assert {_root(s, by_id).id for s in (child, grandchild, sibling)} == {root.id}
        assert root.t0 <= child.t0 <= grandchild.t0 <= grandchild.t1 <= child.t1
        assert child.t1 <= sibling.t0 <= sibling.t1 <= root.t1
        assert root.u0 <= child.u0 <= grandchild.u0 <= grandchild.u1 <= child.u1
        assert child.u1 <= sibling.u0 <= sibling.u1 <= root.u1
    assert _root(first[1], by_id) is not _root(second[1], by_id)
    assert len({s.id for s in got}) == 8
    assert spans(since=first[0].t0, until=first[3].t0) == first
    assert spans(since=t0, until=t0) == []


def test_each_thread_nests_its_own_spans(monkeypatch):
    """A span opened on another thread while one is open here is a root of
    its own (a profiler's state is per thread, so the check is forced on
    in both)."""
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    t0 = time.perf_counter()

    def other():
        with span("other"):
            with span("other.child"):
                pass

    with span("main"):
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        with span("main.child"):
            pass
    by_name = {s.name: s for s in spans(since=t0)}
    assert set(by_name) == {"main", "main.child", "other", "other.child"}
    for root in ("main", "other"):
        assert by_name[root].parent is None
        assert by_name[f"{root}.child"].parent == by_name[root].id


def test_the_log_keeps_the_newest_entries(monkeypatch):
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    assert profiling.LOG_ENTRIES == 65536
    t0 = time.perf_counter()
    for i in range(profiling.LOG_ENTRIES + 5):
        with span(f"s{i}"):
            pass
    got = spans(since=t0)
    assert len(profiling._log) == len(got) == profiling.LOG_ENTRIES
    assert got[0].name == "s5" and got[-1].name == f"s{profiling.LOG_ENTRIES + 4}"


def test_the_trace_clock_is_time_ns(tmp_path):
    """The spans' ``u0`` / ``u1`` come from ``time.time_ns``: the profiler's
    own clock, converted to Unix time as its converter does, reads within 5
    us of it, and a range's start plus the trace's base lies between two
    reads of it taken around the range's opening (the median of many
    reads: a preempted read is an outlier, not a disagreement)."""
    from torch._C import _profiler

    to_unix = _profiler._ApproximateClockToUnixTimeConverter().to_unix_ns
    misses = []
    for _ in range(2000):
        a = time.time_ns()
        u = to_unix(_profiler._get_approximate_time())
        b = time.time_ns()
        misses.append(max(a - u, u - b, 0))
    assert np.median(misses) <= 5000, np.percentile(misses, [50, 90])

    brackets = []
    with _cpu_profile() as prof:
        with torch.profiler.record_function("warm"):
            pass
        for _ in range(200):
            rf = torch.profiler.record_function("stamped")
            a = time.time_ns()
            rf.__enter__()
            b = time.time_ns()
            rf.__exit__(None, None, None)
            brackets.append((a, b))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    starts = sorted(e["ts"] for e in data["traceEvents"]
                    if e.get("ph") == "X" and e["name"] == "stamped")
    assert len(starts) == len(brackets)
    misses = [max(a / 1e3 - u, u - b / 1e3, 0.0) for (a, b), u in
              zip(brackets, (data["baseTimeNanoseconds"] / 1e3 + ts for ts in starts))]
    assert np.median(misses) <= 5.0, np.percentile(misses, [50, 90])


@pytest.mark.parametrize("clock", ["host", "trace"])
def test_spans_match_the_profilers_ranges(tmp_path, clock):
    """On the host clock each span lasts as long as its range; on the trace
    clock, with the base fitted from these same spans
    (``perfbench/idle.py::fit``), each span's stamps sit round its range,
    and those of a span no more than 20 us longer than its range within 20
    us of its ends."""
    pred = _predictor()
    frame = _frame()
    pred.predict_image(frame)
    t0 = time.perf_counter()
    with _cpu_profile() as prof:
        with torch.profiler.record_function("warm"):  # the profiler's first range is slow
            pass
        for _ in range(3):
            pred.predict_image(frame)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    got = spans(since=t0)
    names = {s.name for s in got}
    ranges = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                     and e["name"] in names), key=lambda e: e["ts"])
    assert [e["name"] for e in ranges] == [s.name for s in got] == PREDICT_IMAGE * 3
    if clock == "host":
        for s, e in zip(got, ranges):
            mine, theirs = (s.t1 - s.t0) * 1e6, e["dur"]
            assert abs(mine - theirs) <= max(0.1 * theirs, 50.0), (s.name, mine, theirs)
        return
    base, spread = idle.fit(Trace(json.loads(path.read_text())["traceEvents"]), got)
    assert spread <= idle.SPREAD_US
    tight = 0
    for s, e in zip(got, ranges):
        opened, closed = s.u0 - base - e["ts"], s.u1 - base - (e["ts"] + e["dur"])
        # 1 us: the stamps' float rounding
        assert opened <= 1.0 and closed >= -1.0, (s.name, opened, closed)
        if closed - opened <= 20.0:
            tight += 1
            assert opened >= -20.0 and closed <= 20.0, (s.name, opened, closed)
    assert tight >= len(got) // 3


def test_predict_image_logs_its_spans_in_order():
    pred = _predictor()
    t0 = time.perf_counter()
    with _cpu_profile():
        boxes = pred.predict_image(_frame())
    got = spans(since=t0)
    assert [s.name for s in got] == PREDICT_IMAGE
    by_id = {s.id: s for s in got}
    root = got[0]
    assert root.parent is None and all(_root(s, by_id) is root for s in got)
    for s in got[1:]:
        assert by_id[s.parent].name == PARENT[s.name]
    # the letterbox's three parts follow one another inside it
    letterbox, resize, pad, scale = got[1:5]
    assert letterbox.t0 <= resize.t0 <= resize.t1 <= pad.t0 <= pad.t1 <= scale.t0
    assert scale.t1 <= letterbox.t1
    assert isinstance(boxes, list)


LETTERBOX_HW = [(48, 80), (80, 48), (64, 64), (30, 200)]


def _model_input_is_the_letterbox(pred, hw):
    frame = _frame(*hw)
    seen = []
    heads = pred._heads

    def keep(x):
        seen.append(x.clone())
        return heads(x)

    pred._heads = keep
    pred.predict_image(frame)
    with _cpu_profile():
        pred.predict_image(frame)
    img, _ = letterbox(frame, None, 64)
    want = torch.from_numpy((img.astype(np.float32) / 255.0)[None])
    assert len(seen) == 2
    for x in seen:
        assert x.dtype == torch.float32 and x.device == pred.device
        assert torch.equal(x.cpu(), want)


@pytest.mark.parametrize("hw", LETTERBOX_HW)
def test_predict_image_gives_the_model_the_letterbox_pixels(hw):
    """The letterbox in three spans (resize, pad, scale) hands the model the
    same floats as ``letterbox`` and one division, bit for bit, with or
    without a profiler."""
    _model_input_is_the_letterbox(_predictor(), hw)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K10 runs only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", LETTERBOX_HW)
def test_predict_image_gives_the_model_the_letterbox_pixels_on_the_card(card, hw):
    """The same on a CUDA predictor, whose letterbox is K10 on the device."""
    _model_input_is_the_letterbox(_predictor(card), hw)


@pytest.mark.cuda
def test_predict_image_logs_the_cards_letterbox_spans(card):
    """On the card ``.letterbox`` holds ``.upload`` and ``.resize`` (K10's
    launch), and no ``.pad`` or ``.scale``."""
    pred = _predictor(card)
    pred.predict_image(_frame())
    t0 = time.perf_counter()
    with _cpu_profile():
        pred.predict_image(_frame())
    got = spans(since=t0)
    card_spans = PREDICT_IMAGE[:2] + ["predict_image.upload", "predict_image.resize"] \
        + PREDICT_IMAGE[5:]
    assert [s.name for s in got] == card_spans
    by_id = {s.id: s for s in got}
    assert by_id[got[2].parent].name == by_id[got[3].parent].name == "predict_image.letterbox"
    assert got[1].t0 <= got[2].t0 <= got[2].t1 <= got[3].t0 <= got[3].t1 <= got[1].t1


def test_predict_batch_alone_is_a_root():
    pred = _predictor()
    x = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    t0 = time.perf_counter()
    with _cpu_profile():
        pred.predict_batch(x)
    got = spans(since=t0)
    assert [s.name for s in got] == PREDICT_BATCH
    assert got[0].parent is None and all(s.parent == got[0].id for s in got[1:])


def test_a_train_step_logs_its_three_phases():
    from yolo_for_turbines_tpu_torch.train.trainer import Trainer

    cfg = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    trainer = Trainer(TrainConfig(batch_size=2, compute_dtype="float32"), cfg, device="cpu")
    x, targets = profile_serving.train_batch(2, 64, "cpu")
    t0 = time.perf_counter()
    with _cpu_profile():
        trainer.train_step(trainer.state, x, targets, trainer._anchors(x.shape[1]))
    got = spans(since=t0)
    assert [s.name for s in got] == ["train_step", "train_step.forward", "train_step.backward",
                                     "train_step.optimizer"]
    root = got[0]
    assert root.parent is None
    assert all(s.parent == root.id for s in got[1:])
    assert sum(s.t1 - s.t0 for s in got[1:]) <= root.t1 - root.t0
    assert trainer.state.step == 1
