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
entry in a bounded in-memory log that ``spans()`` reads, stamped twice: on
the host clock (``time.perf_counter``, ``t0`` / ``t1``) and on the
profiler's own clock (``u0`` / ``u1``: the Unix clock in microseconds that
the profiler stamps its events with before it subtracts the trace's base;
``time.time_ns``, which the profiler's converted clock agrees with to well
under 5 us). With the one constant base of a trace, fitted where the same
spans are both ranges and entries, a logged span lands on that trace's
device timeline. Nothing is written out on the way.

``concat_bytes`` counts the bytes that copy passes write into the folded and
the trainable forward's channel concats: ``torch.cat``
(``models/blocks.py::cat_channels``: the walk's upsample, lateral, join and
SPP concats, every CSP stage's, YOLOv7's ELAN, MP and SPPCSPC concats and
RT-DETR's CCFM concats wherever they are not written in place), and on the
card the copy of each part of an in-place concat that no K5 produced (an
upsampled half, a saved route: ``blocks.ChannelConcat``).
``concat_in_place_bytes`` counts the bytes K5 stored straight into concat
slices instead (``blocks.FoldedConv`` with ``out=``); their sum is every
concat's bytes. K8 writes SPP's and SPPCSPC's pool pyramids without a
concat on the card (``blocks.maxpool_pyramid``), counted in neither. Both
count from the process's start, like the kernels' ``launches`` counters:
one integer add per concat or part, with or without a profiler.
``deform_samples`` counts likewise the bilinear samples that RT-DETR's
deformable attention takes (``models/rtdetr.py::MSDeformableAttention``: B
x queries x heads x levels x points per decoder layer).

Besides the spans the callers name, RT-DETR's forward opens
``detr.backbone``, ``detr.encoder`` and ``detr.decoder`` once each and
``detr.deform`` once per decoder layer, around the sampling core.

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
concat_bytes = 0
concat_in_place_bytes = 0
deform_samples = 0


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
    ``time.perf_counter()`` (``t1`` is None while it is open), ``u0`` and
    ``u1`` in microseconds of the profiler's Unix clock (taken next to the
    range's own stamps), its ``id`` and its ``parent``'s id (None at a
    root: the spans of one request or step nest under one root by
    ``parent``)."""

    __slots__ = ("name", "t0", "t1", "u0", "u1", "id", "parent", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer is not None else None
        self.t1 = self.u1 = None
        stack.append(self)
        _log.append(self)
        self._range = torch.profiler.record_function(self.name)
        self.t0 = time.perf_counter()
        self.u0 = time.time_ns() / 1000
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)
        self.u1 = time.time_ns() / 1000
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
