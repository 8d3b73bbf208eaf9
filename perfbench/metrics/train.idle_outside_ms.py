"""Idle device time per step ended by an op launched outside every
``train_step``: the benchmark loop's own ops between steps.

The quiet traced window's idle time (no kernel, copy or memset on the
device), each gap put down to the phase of ``train_step`` whose launch
ended it (``perfbench/idle.py``), over the ``train_step`` spans there;
nothing without the program's clock-stamped spans, with a clock fit spread
over 50 us or with spans that do not fit the quiet trace (``None``)."""

from perfbench import idle


def read(run):
    return idle.per_call_ms(run, "train_step", idle.OUTSIDE)
