"""Trainable mini-model weights for the eval-path parity tests of the port.

Two kinds, both seeded and made on the port's module (its ``init_conv``
weights), then exported as the JAX ``(params, batch_stats)`` trees:

- ``calibrated=False``: BN scale U(0.5, 1.5), bias N(0, 0.2), mean
  N(0, 0.1), var U(0.5, 1.5). The convs shrink their input while each BN
  adds its own offset, so the signal fades through the ~75 layers and every
  head is a constant plus a variation near 1e-5 of it.
- ``calibrated=True``: the same scale and bias, running statistics from one
  train-mode pass over seeded noise images (momentum None: the cumulative
  average of one batch is that batch), jittered (mean + N(0, 0.1) * std,
  var * U(0.7, 1.4)); then each anchor's objectness row of each head's last
  1x1 is scaled and shifted so that its eval-mode logits on those images
  have mean 0 and standard deviation ``OBJECTNESS_STD``. Every layer then
  carries signal, the heads vary from cell to cell, and scores spread
  around the 0.5 threshold, far apart next to the two frameworks'
  differences. ``chip_smoke.py::eval_model`` makes the full-width model on
  the card by the same recipe (drawn from a ``torch.Generator``, objectness
  mean -4): keep the two in step.

The f32 rounding of the two frameworks (about 3e-7 relative per conv, as a
float64 conv measures it) accumulates through normalized layers: on the
calibrated weights the eval heads differ by up to 1.3e-5 relative RMS and
the train-mode heads (normalized by batch statistics whatever the weights)
by up to 5.7e-5. Collapsed heads hide that under their constant part.
"""

import numpy as np
import torch
import torch.nn as nn

from helpers import mini_model
from yolo_for_turbines_tpu_torch.models.convert import trainable_to_numpy
from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3, TrainableHead

OBJECTNESS_STD = 2.0


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


@torch.no_grad()
def eval_weights(seed: int = 0, size: int = 64, num_classes: int = 2, calibrated: bool = True,
                 model=None):
    """(jax model handle, params, batch_stats) as numpy trees; ``model`` is
    a JAX model handle of any family (the mini model by default)."""
    model = mini_model(num_classes) if model is None else model
    port = YOLOv3(model.cfg, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    bns = [m for m in port.modules() if isinstance(m, nn.BatchNorm2d)]
    for bn in bns:
        n = bn.num_features
        bn.weight.copy_(_f32(rng.uniform(0.5, 1.5, n)))
        bn.bias.copy_(_f32(rng.normal(0, 0.2, n)))
        bn.running_mean.copy_(_f32(rng.normal(0, 0.1, n)))
        bn.running_var.copy_(_f32(rng.uniform(0.5, 1.5, n)))
    if calibrated:
        x = torch.from_numpy(rng.uniform(size=(4, size, size, 3)).astype(np.float32))
        for bn in bns:
            bn.reset_running_stats()
            bn.momentum = None
        port.train()(x)
        for bn in bns:
            bn.momentum = 0.1
            std = bn.running_var.sqrt()
            bn.running_mean.add_(_f32(rng.normal(0, 0.1, bn.num_features)) * std)
            bn.running_var.mul_(_f32(rng.uniform(0.7, 1.4, bn.num_features)))
        heads = port.eval()(x)
        c5 = model.cfg.num_classes + 5
        for head, y in zip((m for m in port.layers if isinstance(m, TrainableHead)), heads):
            conv = head.conv2.conv
            for a in range(y.shape[1]):
                row = a * c5 + 4
                free = y[:, a, ..., 4] - conv.bias[row]
                gain = OBJECTNESS_STD / free.std()
                conv.weight[row] *= gain
                conv.bias[row] = -gain * free.mean()
    params, stats = trainable_to_numpy(port)
    return model, params, stats
