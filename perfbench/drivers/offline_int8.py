"""Offline serving on the int8 PTQ path: ``drivers/offline.py``'s closed loop
of ``Predictor.predict_batch`` over device-resident, pre-letterboxed
batches, with the predictor switched to int8 by ``Predictor.quantize`` on
the cell's calibration images (the images ``offline`` calibrates the
folded BN on), so that its forward is the int8 one (K4 on the 26x26x512
stage, the int8 layer path elsewhere).

Checked as in ``offline``: the int8 heads against the reference's float32
forward of the full-precision weights, and the kept boxes against the
reference's decode and NMS of those same heads. The control is the same
int8 path on weights first rounded to 4 bits per output channel (for the
heads), and the reference's decode in bf16 in the program's place (for
the boxes).

With ``--trace 1`` the int8 forward runs inside a range ``model.forward``,
as the folded module's forward does in ``offline``.
"""

from __future__ import annotations

import numpy as np

from .. import traffic
from ..trace import span
from . import offline, seeded


def four_bits(w: np.ndarray) -> np.ndarray:
    """An HWIO weight rounded to 16 levels per output channel, symmetric
    around 0 (-8 to 7 steps of its largest magnitude over 7)."""
    scale = np.abs(w).max(axis=(0, 1, 2), keepdims=True) / 7.0
    scale = np.where(scale > 0, scale, 1.0)
    return (np.clip(np.round(w / scale), -8, 7) * scale).astype(np.float32)


def _round_weights(node) -> None:
    """Every conv weight of a folded tree in the JAX layout, in place."""
    if isinstance(node, dict) and "w" in node:
        node["w"][...] = four_bits(node["w"])
    elif isinstance(node, dict):
        for v in node.values():
            _round_weights(v)
    elif isinstance(node, list):
        for v in node:
            _round_weights(v)


class _Wrapped:
    """A callable attribute run inside a range; ``remove()`` puts it back."""

    def __init__(self, obj, attr: str, name: str):
        self.obj, self.attr, self.inner = obj, attr, getattr(obj, attr)

        def wrapped(*args, **kwargs):
            with span(name):
                return self.inner(*args, **kwargs)

        setattr(obj, attr, wrapped)

    def remove(self) -> None:
        setattr(self.obj, self.attr, self.inner)


class Driver(offline.Driver):
    def __init__(self, cfg: dict, mix: dict, seed: int, device, variant: str = "program"):
        if variant not in ("program", "control"):
            raise ValueError(f"no variant {variant!r} for int8 offline serving")
        super().__init__(cfg, mix, seed, device, "program")
        self.variant = variant
        calib = traffic.device_images(seeded(seed, 1, self.device), mix["calibration_images"],
                                      cfg["image_size"], self.device)
        if variant == "control":
            # quantize() starts from the full-precision tree the predictor holds
            _round_weights(self.pred.full_precision_tree())
        self.pred.quantize(calib)

    def spans(self):
        # the int8 forward is a function of the plan, not the module's
        # forward: the range goes round the predictor's own heads, inside
        # the capture of the checked batches
        return [_Wrapped(self, "_heads", "model.forward")]
