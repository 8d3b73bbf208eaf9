"""Profiling hooks: ``torch.profiler`` traces and the program's own spans
(counterpart of ``yolo_for_turbines_tpu/utils/profiling.py``).

``trace_scope`` captures a trace of the host and, when a card is present,
of the device, that TensorBoard's profiler plugin and Perfetto load.

``span(name)`` marks a phase of the program (the single-image path's
letterbox, copies, forward and fetch; the train step's forward, backward and
update). It does nothing but one ``torch.autograd._profiler_enabled()``
check unless a ``torch.profiler`` is running: a running profiler (an
operator's ``trace_scope``, or a benchmark's) is the only switch. Under
one, a span opens a ``record_function`` range, which lands on the
profiler's timeline beside the kernels and copies it launches, and logs an
entry on the host clock (``time.perf_counter``) in a bounded in-memory log
that ``spans()`` reads. Nothing is written out on the way.

The JAX package's ``StepTimer`` has no counterpart, and its
``enable_compilation_cache`` none either: the port compiles nothing at run
time but its CUDA kernels, whose build ``ops/kernels`` caches in
``_build/``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

LOG_ENTRIES = 65536
_log: collections.deque = collections.deque(maxlen=LOG_ENTRIES)
_ids = itertools.count(1)
_local = threading.local()
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace_scope(log_dir):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (``<worker>.<timestamp>.pt.trace.json``): CPU activity, and CUDA
    activity when a CUDA device is available. Yields the directory."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield log_dir


class Span:
    """One logged span: ``name``, ``t0`` and ``t1`` in seconds of
    ``time.perf_counter()`` (``t1`` is None while it is open), its ``id``,
    its ``parent``'s id (None at a root) and ``request``, the id of the
    outermost span open on its thread when it opened (its own at a root),
    which every span of one request or step shares."""

    __slots__ = ("name", "t0", "t1", "id", "parent", "request", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer is not None else None
        self.request = outer.request if outer is not None else self.id
        self.t1 = None
        stack.append(self)
        _log.append(self)
        self._range = torch.profiler.record_function(self.name)
        self.t0 = time.perf_counter()
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)
        self.t1 = time.perf_counter()
        self._range = None
        _local.stack.pop()


def span(name: str):
    """A context manager around one phase named ``name``: a :class:`Span`
    while a ``torch.profiler`` runs, else a shared ``nullcontext``."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return Span(name)


def spans(since: Optional[float] = None, until: Optional[float] = None) -> List[Span]:
    """The closed spans of the log (its last ``LOG_ENTRIES`` opened) whose
    ``t0`` lies in [since, until] on the ``time.perf_counter()`` clock, in
    the order they opened."""
    lo = float("-inf") if since is None else since
    hi = float("inf") if until is None else until
    return [s for s in list(_log) if s.t1 is not None and lo <= s.t0 <= hi]
