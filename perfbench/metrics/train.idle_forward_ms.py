"""Idle device time per step ended by an op launched in
``train_step.forward`` (the forward and the loss under autocast): bubbles
between its queued kernels, the host falling behind there, and the wait
from the step before's last op to the step's first.

The quiet traced window's idle time (no kernel, copy or memset on the
device), each gap put down to the phase of ``train_step`` whose launch
ended it (``perfbench/idle.py``), over the ``train_step`` spans there;
nothing without the program's clock-stamped spans, with a clock fit spread
over 50 us or with spans that do not fit the quiet trace (``None``)."""

from perfbench import idle


def read(run):
    return idle.per_call_ms(run, "train_step", "train_step.forward")
