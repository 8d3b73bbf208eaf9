"""The optimizer, the lr schedule and the train and eval steps
(counterpart of ``yolo_for_turbines_tpu/train/steps.py``).

- Optimizer: ``torch.optim.SGD(momentum=, weight_decay=)`` over every
  trainable parameter, BN scale and bias and the heads' conv bias
  included: optax's ``add_decayed_weights`` decays every params leaf.
  torch adds the decay to the gradient before the momentum buffer, as
  ``chain(add_decayed_weights, sgd(momentum))`` does, and starts the buffer
  at the first gradient, which is what optax's zero-initialised trace gives.
- Schedule: :func:`scheduled_lr`, linear warmup from 1e-6 * lr over
  ``max(1, int(max_num_steps * warmup))`` steps, then constant, or a cosine
  decay to 0 at ``max_num_steps`` when ``decay_lr`` (only while warmup is
  on). It runs on the host for the step before the increment and is
  written into the param groups; ``TrainState.hyper`` holds its numbers.
- Freeze: a frozen parameter stays out of the optimizer and stops
  requiring a gradient, so its update is exactly 0, weight decay included
  (the JAX package masks the final update). Running statistics of frozen
  BN layers still update in train mode, as in JAX.
- Precision: ``compute_dtype`` bfloat16 runs the f32 module's forward under
  ``torch.autocast`` with an f32 loss and no GradScaler (bf16 has f32's
  exponent range); float32 runs forward and backward with TF32 off
  (``models/blocks.py::full_f32``).

- Mesh: with ``mesh=`` (``parallel/``) each rank runs the step on its
  shard of the global batch (``shard_batch``, or ``shard_spatial_batch`` on
  a ``("data", "space")`` mesh) and the update is the single-process
  step's on the global batch, as the JAX sharded step's is: train-mode BN
  takes the global batch's moments (``parallel/comm.py::sync_batch_norm``),
  the loss divides by the global batch's counts, and after ``backward`` one
  flat all-reduce sums the gradients over the mesh. The sum is explicit
  rather than DistributedDataParallel's: the step's other collectives (BN
  moments, and halo rows under SP) run inside ``backward`` on the same
  groups, and one all-reduce after it keeps a single collective order on
  every rank; and under SP the gradient is a plain sum over data x space,
  which DDP's mean over the world would have to undo. Every rank gets the
  global loss terms.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Iterable

import numpy as np
import torch
import torch.nn as nn

from ..config import TrainConfig
from ..models.blocks import full_f32
from .evaluate import _forward
from .loss import total_yolo_loss

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype_of(name: str) -> torch.dtype:
    """``TrainConfig.compute_dtype`` as a torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


def hyper_from_config(cfg: TrainConfig) -> Dict[str, float]:
    """The schedule's numbers: peak lr, warmup steps (0 with warmup off),
    total steps, and 1.0 for a cosine decay (only while warmup is on)."""
    warmup_steps = max(1, int(cfg.max_num_steps * cfg.warmup)) if cfg.warmup_enabled else 0
    return {
        "lr": float(cfg.lr),
        "warmup_steps": float(warmup_steps),
        "total_steps": float(cfg.max_num_steps),
        "use_cosine": 1.0 if (cfg.decay_lr and cfg.warmup_enabled) else 0.0,
    }


def scheduled_lr(step: int, hyper: Dict[str, float]) -> float:
    """The lr at ``step``: warmup, then constant or cosine decay. float32
    arithmetic in the JAX function's operation order."""
    f32 = np.float32
    stepf = f32(step)
    lr_peak, ws = f32(hyper["lr"]), f32(hyper["warmup_steps"])
    frac = np.minimum(stepf / np.maximum(ws, f32(1.0)), f32(1.0))
    lr_warm = lr_peak * (f32(1e-6) + f32(1.0 - 1e-6) * frac)
    t = np.clip((stepf - ws) / np.maximum(f32(hyper["total_steps"]) - ws, f32(1.0)),
                f32(0.0), f32(1.0))
    lr_cos = lr_peak * f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * t))
    lr_after = lr_cos if hyper["use_cosine"] > 0 else lr_peak
    return float(lr_warm if stepf < ws else lr_after)


def warmup_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """step -> lr of ``cfg``: the JAX package's optax schedule (linear
    warmup from 1e-6 * lr, then constant or cosine decay; constant with
    warmup off), as :func:`scheduled_lr` computes it."""
    hyper = hyper_from_config(cfg)
    return lambda step: scheduled_lr(step, hyper)


def make_optimizer(cfg: TrainConfig, frozen: Iterable[str] = ()):
    """``(build, schedule)``: ``build(model)`` freezes the named parameters
    (``model.named_parameters()`` names) and returns the SGD over the rest
    (momentum, weight decay before it) at the schedule's lr of step 0;
    ``schedule`` is :func:`warmup_schedule`. The JAX ``make_optimizer``'s
    pair of a masked optax transformation and its schedule."""
    frozen = tuple(frozen)
    schedule = warmup_schedule(cfg)

    def build(model: nn.Module) -> torch.optim.Optimizer:
        freeze_parameters(model, frozen)
        return torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                               lr=schedule(0), momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay)

    return build, schedule


@dataclasses.dataclass
class TrainState:
    """The module, its SGD optimizer, the count of steps taken and the
    schedule's numbers (``hyper_from_config``)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    hyper: Dict[str, float]

    def snapshot(self) -> dict:
        """A host copy: the module's ``state_dict`` (running statistics
        included), the optimizer's (momentum buffers), step and hyper, every
        tensor copied to the CPU."""
        return {"model": _host(self.model.state_dict()),
                "optimizer": _host(self.optimizer.state_dict()),
                "step": int(self.step), "hyper": dict(self.hyper)}


def _host(obj):
    """``obj`` with every tensor copied to the CPU (containers rebuilt)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def freeze_parameters(model: nn.Module, names: Iterable[str]) -> None:
    """Stop the named parameters (``model.named_parameters()`` names) from
    requiring a gradient."""
    names = set(names)
    params = dict(model.named_parameters())
    unknown = names - params.keys()
    if unknown:
        raise ValueError(f"no such parameters: {sorted(unknown)}")
    for name in names:
        params[name].requires_grad_(False)


def create_train_state(model: nn.Module, cfg: TrainConfig, frozen: Iterable[str] = ()) -> TrainState:
    """Freeze ``frozen``, then SGD over every parameter left trainable
    (:func:`make_optimizer`)."""
    build, _ = make_optimizer(cfg, frozen)
    return TrainState(model, build(model), 0, hyper_from_config(cfg))


def _metrics(total, comps, layout) -> dict:
    metrics = {k: v.detach() for k, v in comps.items()}
    metrics["loss"] = total.detach()
    return metrics if layout is None else layout.reduce_metrics(metrics)


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, images: torch.Tensor,
               targets, scaled_anchors, compute_dtype: torch.dtype = torch.bfloat16,
               layout=None):
    """One SGD step in train mode at the lr in the optimizer's param groups.

    ``images`` (B, S, S, 3) and ``targets`` (3 tensors (B, A, S, S, 6),
    coarsest first) on the module's device; ``scaled_anchors`` (3, A, 2) in
    cell units. Returns the loss terms and "loss" as detached device
    tensors (no host sync). With ``layout``
    (``parallel/spatial.py::Layout``) the batch is this rank's shard and the
    step is the global batch's (module docstring)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    f32 = compute_dtype == torch.float32
    reduce_counts = None if layout is None else layout.reduce_counts
    with full_f32() if f32 else contextlib.nullcontext():
        with contextlib.nullcontext() if f32 else torch.autocast(images.device.type,
                                                                 dtype=compute_dtype):
            total, comps = total_yolo_loss(model(images, layout=layout), targets,
                                           scaled_anchors, reduce_counts)
        if layout is None:
            total.backward()
        else:
            (total * layout.loss_weight).backward()
            layout.reduce_gradients(p for p in model.parameters() if p.requires_grad)
    optimizer.step()
    return _metrics(total, comps, layout)


@torch.no_grad()
def eval_step(model: nn.Module, images: torch.Tensor, targets, scaled_anchors,
              compute_dtype: torch.dtype = torch.bfloat16, layout=None):
    """Forward and loss in eval mode, no gradients (the module's mode is
    restored after it): the loss terms and "loss" as device tensors, of the
    global batch with ``layout``."""
    total, comps = total_yolo_loss(_forward(model, images, compute_dtype, layout), targets,
                                   scaled_anchors,
                                   None if layout is None else layout.reduce_counts)
    return _metrics(total, comps, layout)


def _layout(mesh):
    if mesh is None:
        return None
    from ..parallel.spatial import Layout

    return Layout(mesh)


def make_train_step(cfg: TrainConfig, mesh=None):
    """fn(state, images, targets, scaled_anchors) -> metrics: writes the lr
    of ``state.step`` into the param groups, takes one :func:`train_step`
    in ``cfg.compute_dtype`` and counts it. With ``mesh`` (``parallel/``)
    the inputs are this rank's shards and the step is the global batch's;
    every rank of the mesh calls it."""
    dtype = compute_dtype_of(cfg.compute_dtype)
    layout = _layout(mesh)

    def step(state: TrainState, images, targets, scaled_anchors):
        lr = scheduled_lr(state.step, state.hyper)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        metrics = train_step(state.model, state.optimizer, images, targets, scaled_anchors,
                             dtype, layout)
        state.step += 1
        return metrics

    return step


def make_forward_eval(cfg: TrainConfig):
    """fn(state, images) -> the eval-mode raw heads (B, A, S, S, 5+C), f32,
    in ``cfg.compute_dtype`` (running statistics; the module's mode is
    restored after it), without gradients."""
    dtype = compute_dtype_of(cfg.compute_dtype)

    @torch.no_grad()
    def fwd(state: TrainState, images):
        return _forward(state.model, images, dtype)

    return fwd


def make_eval_step(cfg: TrainConfig, mesh=None):
    """fn(state, images, targets, scaled_anchors) -> metrics: :func:`eval_step`
    in ``cfg.compute_dtype``, over the mesh's global batch with ``mesh``."""
    dtype = compute_dtype_of(cfg.compute_dtype)
    layout = _layout(mesh)

    def step(state: TrainState, images, targets, scaled_anchors):
        return eval_step(state.model, images, targets, scaled_anchors, dtype, layout)

    return step
