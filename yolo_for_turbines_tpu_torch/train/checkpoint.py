"""Checkpoints: the module's ``state_dict``, the SGD state, step and the
schedule's numbers in one ``torch.save`` file (counterpart of
``yolo_for_turbines_tpu/train/checkpoint.py``; reference:
code/utils.py:383-416).

Loading uses ``torch.load(weights_only=True)``: the file holds tensors,
numbers, strings and containers only. ``lr_override`` forces the restored
schedule's peak lr, the reference's forcing of lr into the param groups on
load.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

import torch

from .steps import TrainState


def save_checkpoint(state: Union[TrainState, dict], filename) -> None:
    """Write a ``TrainState`` or its :meth:`TrainState.snapshot` to
    ``filename`` (replaced atomically)."""
    payload = state.snapshot() if isinstance(state, TrainState) else state
    path = Path(filename)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def load_model_state(model: torch.nn.Module, filename) -> None:
    """Load only the module part of ``filename`` (weights and running
    statistics) into ``model``, in place on its device."""
    payload = torch.load(Path(filename), map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])


def load_checkpoint(state: TrainState, filename,
                    lr_override: Optional[float] = None) -> TrainState:
    """Load ``filename`` into ``state`` (its module and optimizer, on their
    device) and return it."""
    payload = torch.load(Path(filename), map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    state.hyper = {k: float(v) for k, v in payload["hyper"].items()}
    if lr_override is not None:
        state.hyper["lr"] = float(lr_override)
    return state
