"""Idle device time per batch ended by an op launched in
``predict_batch.forward``: bubbles between the forward's queued kernels,
and the host falling behind the device there.

The quiet traced window's idle time (no kernel, copy or memset on the
device), each gap put down to the phase of ``Predictor.predict_batch``
whose launch ended it (``perfbench/idle.py``), over the ``predict_batch``
spans there; nothing without the program's clock-stamped spans, with a
clock fit spread over 50 us or with spans that do not fit the quiet trace
(``None``)."""

from perfbench import idle


def read(run):
    return idle.per_call_ms(run, "predict_batch", "predict_batch.forward")
