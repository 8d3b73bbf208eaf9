"""The trace reader on a hand-made Chrome trace."""

from perfbench.trace import Trace, union


def ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


EVENTS = [
    ev("user_annotation", "perfbench.window", 0, 1000),
    ev("user_annotation", "perfbench.call", 10, 400),
    ev("user_annotation", "model.forward", 20, 200),
    ev("cpu_op", "aten::conv", 30, 20),
    ev("cuda_runtime", "cudaLaunchKernel", 35, 5, corr=1),
    ev("cuda_runtime", "cudaLaunchKernel", 250, 5, corr=2),
    ev("cuda_driver", "cuLaunchKernel", 300, 5, corr=3),
    ev("kernel", "conv_kernel", 100, 100, corr=1),
    ev("kernel", "nms_kernel", 150, 100, corr=2),   # overlaps the conv on another stream
    ev("gpu_memcpy", "Memcpy DtoH", 600, 50, corr=3),
    ev("kernel", "stray", 2000, 10, corr=9),        # outside the window, no launch
    ev("user_annotation", "perfbench.call", 500, 100),
]


def test_union_merges_overlaps():
    assert union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]


def test_busy_is_the_union_inside_the_window():
    t = Trace(EVENTS)
    assert t.window_s() == 1000e-6
    assert abs(t.busy_s() - 200e-6) < 1e-12  # 100-250 and 600-650
    assert t.unlinked == 1


def test_spans_by_launch_correlation():
    t = Trace(EVENTS)
    assert t.count("perfbench.call") == 2
    assert abs(t.busy_s(inside="model.forward") - 100e-6) < 1e-12
    assert abs(t.busy_s(inside="perfbench.call", outside="model.forward") - 150e-6) < 1e-12
    assert len(t.events(inside="perfbench.call")) == 3


def test_quiet_trace_takes_its_window_from_the_host():
    t = Trace([e for e in EVENTS if e["cat"] in ("kernel", "gpu_memcpy")], seconds=0.5)
    assert t.window_s() == 0.5
    assert abs(t.busy_s() - 210e-6) < 1e-12


def test_breakdown():
    t = Trace(EVENTS)
    ops = dict(t.device_ops())
    assert set(ops) == {"conv_kernel", "nms_kernel", "Memcpy DtoH"}
    gaps = dict(t.idle_gaps())
    assert abs(sum(gaps.values()) - 800e-6) < 1e-12
    assert gaps["perfbench.window"] > 0
