"""The benchmark of ``yolo_for_turbines_tpu_torch``, the PyTorch and CUDA
port of the YOLOv3 detector, on NVIDIA H100s.

One command runs one cell once, from the root of a checkout:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(``python -m perfbench.run`` takes the same arguments). ``BENCHMARK.json``
at the root lists the configurations, the cells (``workloads``) and the
metrics. A cell names a configuration (``configs/<name>.json``) and a
traffic mix (``traffic/<mix>.json``); the mix's ``kind`` names the driver
(``drivers/<kind>.py``), the only code that calls the program. Each metric is
read by ``metrics/<name>.py`` and each cell's limits on the numbers compared
with the reference are in ``limits/<cell>.json``. See ``README.md`` for the
cells and for how to add one.

A run: set-up (weights and inputs from the seed on the card, the program's
objects, a warm-up of every shape the cell uses), a window of ``--seconds``
(with ``--trace 1``: twice at most the mix's ``trace_iterations`` calls
under the profiler, first the device alone, then with the host's ops and
spans from the benchmark's own hooks; see ``trace.py``), then the program's
state is freed and the outputs kept from the window are compared with the
plain float32 reference (``reference/``). The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit; the same numbers are the last lines of
standard error. Earlier lines carry the card's name, power limit and SM
clock, the program's kernel counters and build time, and the trace's
unlinked device events.

It exits with another code than 0, printing no result, without a CUDA card
(or fewer than the cell asks for), or when a module of JAX or of the JAX
package (``yolo_for_turbines_tpu``) is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "yolo_for_turbines_tpu")


def forbidden_modules(names=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


class Run:
    """What the metric readers read: the cell, its configuration and mix,
    the window's calls as (start, end, images) on the host clock, the
    window's seconds, the set-up's seconds and, in a traced run, the two
    traces (``trace``: spans and host ops; ``quiet``: the device alone, over
    ``records``; see ``trace.py``)."""

    def __init__(self, cell, cfg, mix, records, elapsed, setup_s, trace=None, quiet=None):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.records, self.elapsed, self.setup_s = records, elapsed, setup_s
        self.trace, self.quiet = trace, quiet


def measure(driver, seconds: float, limit=None):
    """Calls ``driver.step`` until ``seconds`` have passed (or ``limit``
    calls), then ``driver.finish``: ((start, end, images) per call, the
    window's seconds to the end of ``finish``)."""
    records = []
    t0 = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        n = driver.step(i)
        b = time.perf_counter()
        records.append((a, b, n))
        i += 1
        if b - t0 >= seconds or (limit is not None and i >= limit):
            break
    driver.finish()
    return records, time.perf_counter() - t0


def gpu_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def counters() -> dict:
    from yolo_for_turbines_tpu_torch.ops import kernels
    from yolo_for_turbines_tpu_torch.ops.kernels import (
        iou_kernel, nms_kernel, resblock_int8_kernel, resblock_kernel)

    return {"k1_launches": nms_kernel.launches, "k2_launches": resblock_kernel.launches,
            "k3_launches": iou_kernel.launches, "k4_launches": resblock_int8_kernel.launches,
            "kernel_build_s": kernels.build_seconds}


def run_cell(bench, cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, variant: str = "program", emit=print) -> dict:
    """One run of ``cell``; returns the result line's object. ``emit`` takes
    the earlier lines."""
    import torch

    from perfbench import drivers
    from perfbench.trace import profile, span

    device = torch.device(device)
    cfg, mix, limits = bench.config(cell), bench.mix(cell), bench.limits(cell)
    driver = drivers.load(mix["kind"])(cfg, mix, seed, device, variant)
    driver.warm()
    driver.finish()
    held = quiet = None
    if trace:
        handles = driver.spans()
        driver.call_span = lambda: span("perfbench.call")
        setup_s = time.perf_counter() - t_start
        with profile(host=False) as quiet:
            records, elapsed = measure(driver, seconds, mix["trace_iterations"])
            quiet.seconds = elapsed
        with profile() as held:
            with span("perfbench.window"):
                measure(driver, seconds, mix["trace_iterations"])
        for h in handles:
            h.remove()
    else:
        setup_s = time.perf_counter() - t_start
        records, elapsed = measure(driver, seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    emit(json.dumps({"counters": counters()}))
    attempted = driver.attempted
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.check()
    checks = {}
    for name, limit in limits.items():
        checks[name] = {"value": numbers.get(name), "limit": limit}
    emit(json.dumps({"also_compared": {k: v for k, v in numbers.items() if k not in limits}}))
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    tr = held.trace if held is not None else None
    qt = quiet.trace if quiet is not None else None
    run = Run(cell, cfg, mix, records, elapsed, setup_s, tr, qt)
    metrics = {}
    for m in bench.metrics(cell, "per_layer" if trace else "end_to_end"):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": dev}
    if tr is not None:
        emit(json.dumps({"trace": {"unlinked_device_events": tr.unlinked,
                                   "device_events": len(tr.device),
                                   "quiet_device_events": len(qt.device),
                                   "spans_busy_s": tr.busy_s(), "spans_window_s": tr.window_s()}}))
        dev["busy_s"] = qt.busy_s()
        dev["window_s"] = qt.window_s()
        result["breakdown"] = {"device_ops": qt.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench.manifest import Bench

    bench = Bench.load(ROOT / "BENCHMARK.json")
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"this cell needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(json.dumps({"gpu": gpu_line(), "torch": torch.__version__}), flush=True)
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                      emit=lambda line: print(line, flush=True))
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps({"gpu_after": gpu_line()}), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
