"""Profiling hooks: ``torch.profiler`` traces and per-step wall timing
(counterpart of ``yolo_for_turbines_tpu/utils/profiling.py``).

``trace_scope`` captures a trace of the host and, when a card is present,
of the device, that TensorBoard's profiler plugin and Perfetto load;
``StepTimer`` tracks host-side step latency percentiles cheaply enough to
stay on in production. The JAX package's ``enable_compilation_cache`` has
no counterpart: the port compiles nothing at run time but its CUDA kernels,
whose build ``ops/kernels`` caches in ``_build/``.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, List, Optional


@contextlib.contextmanager
def trace_scope(log_dir):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (``<worker>.<timestamp>.pt.trace.json``): CPU activity, and CUDA
    activity when a CUDA device is available. Yields the directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield log_dir


class StepTimer:
    """Host wall-clock step timer with percentile summaries."""

    def __init__(self, capacity: int = 10_000):
        self.samples: List[float] = []
        self.capacity = capacity
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        if len(self.samples) < self.capacity:
            self.samples.append(dt)
        return dt

    @contextlib.contextmanager
    def measure(self):
        self.start()
        yield
        self.stop()

    def summary(self) -> Dict[str, float]:
        import numpy as np

        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "p99_s": float(np.percentile(arr, 99)),
        }
