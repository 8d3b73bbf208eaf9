"""Plain YOLOv3 loss and SGD step: the benchmark's reference for training.

The loss is YOLOv3's four terms per scale, summed over the scales
(Redmon and Farhadi, arXiv:1804.02767; the weights of GabeTsai/YOLO-For-Turbines
``code/loss.py``):

- no object (weight 0.5): binary cross-entropy of the objectness logit
  against 0 over the cells whose target objectness is 0;
- object (1): squared error of sigmoid(objectness) against the IoU of the
  predicted and the target box (no gradient through the IoU), over the cells
  whose target objectness is 1;
- box (5): squared error of [sigmoid(tx), sigmoid(ty), tw, th] against
  [x, y, log(1e-16 + w / anchor), log(1e-16 + h / anchor)] over those cells
  and the four terms;
- class (1): softmax cross-entropy over those cells.

Each mean divides by its count, at least 1. Targets are ``(B, A, S, S, 6)``
``[x, y, w, h, obj, class]`` in cell units, obj -1 marking a cell left out of
both masks; anchors are in cell units.

:func:`sgd_step` is SGD with momentum and L2 weight decay as
``torch.optim.SGD`` defines it: d = g + wd * p; the buffer starts at the
first d, then b = momentum * b + d; p -= lr * b.

It imports nothing of the measured program.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from .postprocess import iou_center

WEIGHTS = {"box_loss": 5.0, "obj_loss": 1.0, "no_obj_loss": 0.5, "class_loss": 1.0}


def _mean(v, mask, count_mult: int = 1):
    n = mask.sum() * count_mult
    m = mask if v.dim() == mask.dim() else mask[..., None]
    return torch.where(m, v, torch.zeros_like(v)).sum() / n.clamp(min=1)


def scale_loss(pred, target, anchors) -> Dict[str, torch.Tensor]:
    pred, target = pred.float(), target.float()
    anchors = anchors.reshape(1, -1, 1, 1, 2).float()
    obj = target[..., 4] == 1
    noobj = target[..., 4] == 0
    logit = pred[..., 4]
    bce = F.softplus(logit) - logit * target[..., 4]
    xy = torch.sigmoid(pred[..., 0:2])
    wh = torch.exp(pred[..., 2:4]) * anchors
    with torch.no_grad():
        iou = iou_center(torch.cat([xy, wh], -1), target[..., 0:4])
    obj_sq = (torch.sigmoid(logit) - iou * target[..., 4]) ** 2
    box_pred = torch.cat([xy, pred[..., 2:4]], -1)
    box_want = torch.cat([target[..., 0:2], torch.log(1e-16 + target[..., 2:4] / anchors)], -1)
    labels = target[..., 5].long().clamp(0, pred.shape[-1] - 6)
    ce = -torch.log_softmax(pred[..., 5:], -1).gather(-1, labels[..., None])[..., 0]
    return {
        "box_loss": WEIGHTS["box_loss"] * _mean((box_pred - box_want) ** 2, obj, 4),
        "obj_loss": WEIGHTS["obj_loss"] * _mean(obj_sq, obj),
        "no_obj_loss": WEIGHTS["no_obj_loss"] * _mean(bce, noobj),
        "class_loss": WEIGHTS["class_loss"] * _mean(ce, obj),
    }


def total_loss(preds: List[torch.Tensor], targets, scaled_anchors):
    """(total, terms) summed over the scales."""
    terms = None
    for p, t, a in zip(preds, targets, scaled_anchors):
        s = scale_loss(p, t, a)
        terms = s if terms is None else {k: terms[k] + s[k] for k in s}
    return sum(terms.values()), terms


@torch.no_grad()
def sgd_step(params: List[torch.Tensor], buffers: List, lr: float, momentum: float,
             weight_decay: float) -> None:
    """One step over ``params`` (their ``.grad`` read); ``buffers`` holds one
    momentum buffer per parameter, None before the first step."""
    for i, p in enumerate(params):
        d = p.grad + weight_decay * p
        buffers[i] = d.clone() if buffers[i] is None else buffers[i].mul_(momentum).add_(d)
        p.sub_(lr * buffers[i])
