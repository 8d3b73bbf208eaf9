"""Idle device time per batch ended by an op launched in
``predict_batch.input`` (the input's and the scaled anchors' copies to the
device): from the device's last op before the call (the fetch's copy) to
the call's first op, so the benchmark loop's steps between calls and the
phase's host work before its first copy.

The quiet traced window's idle time (no kernel, copy or memset on the
device), each gap put down to the phase of ``Predictor.predict_batch``
whose launch ended it (``perfbench/idle.py``), over the ``predict_batch``
spans there; nothing without the program's clock-stamped spans, with a
clock fit spread over 50 us or with spans that do not fit the quiet trace
(``None``)."""

from perfbench import idle


def read(run):
    return idle.per_call_ms(run, "predict_batch", "predict_batch.input")
