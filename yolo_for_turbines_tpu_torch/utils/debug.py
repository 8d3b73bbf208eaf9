"""NaN guards for debug runs (reference: code/model.py:175,183-184;
code/train.py:84-85).

- ``debug_nans`` / ``debug_nans_scope``: autograd's anomaly mode, which
  names the forward op whose backward produced a NaN (slow: debug runs
  only).
- ``checked_loss``: a loss function wrapped to raise on a non-finite loss.
  It reads the loss on the host, a device sync per call; the trainer
  itself checks once per epoch.
"""

from __future__ import annotations

import contextlib

import torch


def debug_nans(enable: bool = True) -> None:
    """Turn autograd's anomaly detection on or off for the process."""
    torch.autograd.set_detect_anomaly(enable)


@contextlib.contextmanager
def debug_nans_scope():
    """Anomaly detection on inside the block, restored after it."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


def checked_loss(loss_fn):
    """Wrap ``loss_fn`` so that a non-finite loss raises FloatingPointError.

    The loss is the result, or its first element when it is a tuple (as
    ``total_yolo_loss`` returns); the wrapped function returns what
    ``loss_fn`` returns."""

    def wrapped(*args, **kwargs):
        out = loss_fn(*args, **kwargs)
        loss = out[0] if isinstance(out, tuple) else out
        if not bool(torch.isfinite(torch.as_tensor(loss)).all()):
            raise FloatingPointError("non-finite loss detected")
        return out

    return wrapped
