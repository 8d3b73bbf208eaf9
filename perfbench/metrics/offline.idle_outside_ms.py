"""Idle device time per batch ended by an op launched outside every
``predict_batch``: the benchmark loop's fetch of ``(kept, mask)`` to the
host (the wait from the call's last kernel to each copy).

The quiet traced window's idle time (no kernel, copy or memset on the
device), each gap put down to the phase of ``Predictor.predict_batch``
whose launch ended it (``perfbench/idle.py``), over the ``predict_batch``
spans there; nothing without the program's clock-stamped spans, with a
clock fit spread over 50 us or with spans that do not fit the quiet trace
(``None``)."""

from perfbench import idle


def read(run):
    return idle.per_call_ms(run, "predict_batch", idle.OUTSIDE)
