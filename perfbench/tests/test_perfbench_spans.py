"""The readers of the program's spans (``metrics/stream.*_ms.py`` and
``metrics/train.*_host_ms.py``) on tiny traced runs on the CPU, and on a
window in which the program logged no span."""

import time

import pytest

from perfbench import run

READERS = {
    "turbines416-stream-bf16": ("stream.letterbox_ms", "stream.h2d_ms", "stream.dispatch_ms",
                                "stream.fetch_ms"),
    "turbines416-train-step": ("train.forward_host_ms", "train.backward_host_ms",
                               "train.optimizer_host_ms"),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_readers_read_a_traced_run(tiny_bench, name):
    # the traced windows stop at the mix's trace_iterations calls
    result = run.run_cell(tiny_bench, tiny_bench.cell(name), 2**31 + 29, 10.0, True, "cpu",
                          time.perf_counter(), emit=lambda line: None)
    assert result["correct"], result["checks"]
    for metric in READERS[name]:
        got = result["metrics"][metric]
        assert got["unit"] == "ms" and got["value"] > 0, (metric, got)


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_readers_read_nothing_without_spans(tiny_bench, name):
    """Over a whole untraced run (no profiler, so no span logged), and over
    no call at all."""
    cell = tiny_bench.cell(name)
    t0 = time.perf_counter()
    run.run_cell(tiny_bench, cell, 2**31 + 29, 0.3, False, "cpu", t0, emit=lambda line: None)
    untraced = run.Run(cell, {}, {}, [(t0, time.perf_counter(), 1)], 1.0, 0.0)
    empty = run.Run(cell, {}, {}, [], 0.0, 0.0)
    for metric in READERS[name]:
        assert tiny_bench.reader(metric)(untraced) is None, metric
        assert tiny_bench.reader(metric)(empty) is None, metric
