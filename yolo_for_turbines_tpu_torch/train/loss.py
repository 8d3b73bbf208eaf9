"""The 4-term YOLOv3 loss on torch tensors (counterpart of
``yolo_for_turbines_tpu/train/loss.py``).

- no-object loss: BCE with logits on the objectness where the target
  objectness is 0 (the -1 "ignore" cells are in neither mask), mean over
  those cells; lambda 0.5.
- object loss: MSE of sigmoid(objectness) against the IoU of the predicted
  and the target box, over object cells, the IoU without gradient; lambda 1.
- box loss: MSE over object cells of [sigmoid(tx), sigmoid(ty), tw, th]
  against [x_cell, y_cell, log(1e-16 + w / anchor), log(1e-16 + h /
  anchor)]; lambda 5.
- class loss: softmax cross-entropy over object cells; lambda 1.

``legacy=True`` keeps the reference's in-place quirks (code/loss.py:67,71):
the box loss reads [raw tx, sigmoid(ty), sigmoid(tw), raw th] and the
object loss the raw objectness logit.

Masked means are sum(where(mask, v, 0)) / max(count, 1), in the operation
order of the JAX function. On a mesh each rank holds part of the batch, and
a mean of the ranks' means is not the global mean: ``total_yolo_loss``
then takes ``reduce_counts``, which sums the object and no-object counts of
every scale over the ranks in one collective, and each rank's terms become
its share of the global terms (its sums over the global counts).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.iou import calc_iou

LAMBDA_BOX = 5.0
LAMBDA_OBJ = 1.0
LAMBDA_NOOBJ = 0.5
LAMBDA_CLASS = 1.0


def _masked_mean(values, mask, n_extra: int = 1, count=None):
    """Mean of ``values`` where ``mask`` (broadcast over trailing dims) is
    set; ``count`` (the mask's count over the global batch) in place of the
    mask's own."""
    count = (mask.sum() if count is None else count) * n_extra
    m = mask if values.dim() == mask.dim() else mask[..., None]
    total = torch.where(m, values, torch.zeros_like(values)).sum()
    return total / count.clamp(min=1)


def _bce_with_logits(logits, labels):
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(
        torch.exp(-torch.abs(logits)))


def yolo_loss(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    anchors,
    legacy: bool = False,
    counts=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Loss of one scale.

    Args:
        predictions: (B, A, S, S, 5+C) raw heads.
        targets: (B, A, S, S, 6) [x_cell, y_cell, w_cell, h_cell, obj, class];
            obj is 1 (object), 0 (background) or -1 (ignore).
        anchors: (A, 2) anchors in cell units (scaled by the grid size).
        legacy: the reference's in-place-mutation quirks (module docstring).
        counts: (object cells, no-object cells) over the global batch, when
            this is one rank's part of it.

    Returns:
        (box_loss, object_loss, no_object_loss, class_loss), each weighted
        by its lambda.
    """
    predictions = predictions.float()
    targets = torch.as_tensor(targets, device=predictions.device).float()
    anchors = torch.as_tensor(anchors, dtype=torch.float32,
                              device=predictions.device).reshape(1, -1, 1, 1, 2)

    obj_mask = targets[..., 4] == 1
    noobj_mask = targets[..., 4] == 0
    n_obj, n_noobj = (None, None) if counts is None else counts

    # no-object loss
    noobj_bce = _bce_with_logits(predictions[..., 4], targets[..., 4])
    no_object_loss = _masked_mean(noobj_bce, noobj_mask, count=n_noobj)

    # object loss: the objectness should predict the IoU with the target
    pred_xy = torch.sigmoid(predictions[..., 0:2])
    pred_wh = torch.exp(predictions[..., 2:4]) * anchors
    pred_boxes = torch.cat([pred_xy, pred_wh], dim=-1)
    with torch.no_grad():
        ious = calc_iou(pred_boxes, targets[..., 0:4], box_format="center")
    obj_pred = predictions[..., 4] if legacy else torch.sigmoid(predictions[..., 4])
    obj_sq = (obj_pred - ious * targets[..., 4]) ** 2
    object_loss = _masked_mean(obj_sq, obj_mask, count=n_obj)

    # box loss in cell-offset space (wh as log-offsets)
    target_wh = torch.log(1e-16 + targets[..., 2:4] / anchors)
    if legacy:
        # the reference's sigmoid lands on channels [1:3] = (ty, tw)
        pred_box_terms = torch.cat(
            [predictions[..., 0:1], torch.sigmoid(predictions[..., 1:3]),
             predictions[..., 3:4]], dim=-1)
    else:
        pred_box_terms = torch.cat([pred_xy, predictions[..., 2:4]], dim=-1)
    target_box_terms = torch.cat([targets[..., 0:2], target_wh], dim=-1)
    box_sq = (pred_box_terms - target_box_terms) ** 2
    box_loss = _masked_mean(box_sq, obj_mask, n_extra=4, count=n_obj)

    # class loss: softmax CE against a one-hot of the integer label (a label
    # outside [0, C) gives a zero row, as jax.nn.one_hot does)
    logits = predictions[..., 5:]
    labels = targets[..., 5].to(torch.int32)
    log_probs = torch.log_softmax(logits, dim=-1)
    classes = torch.arange(logits.shape[-1], dtype=torch.int32, device=logits.device)
    onehot = (labels[..., None] == classes).to(log_probs.dtype)
    ce = -torch.sum(log_probs * onehot, dim=-1)
    class_loss = _masked_mean(ce, obj_mask, count=n_obj)

    return (
        LAMBDA_BOX * box_loss,
        LAMBDA_OBJ * object_loss,
        LAMBDA_NOOBJ * no_object_loss,
        LAMBDA_CLASS * class_loss,
    )


def total_yolo_loss(
    predictions: Sequence[torch.Tensor],
    targets: Sequence[torch.Tensor],
    scaled_anchors,
    reduce_counts=None,
):
    """The 4 terms summed over the scales: (total, {"box_loss", "obj_loss",
    "no_obj_loss", "class_loss"}). ``reduce_counts`` maps the (scales, 2)
    tensor of this rank's object and no-object counts to the global ones
    (``parallel/spatial.py::Layout.reduce_counts``)."""
    counts = [None] * len(predictions)
    if reduce_counts is not None:
        local = torch.stack([torch.stack([(torch.as_tensor(t)[..., 4] == v).sum() for v in (1, 0)])
                             for t in targets]).to(predictions[0].device)
        counts = list(reduce_counts(local).unbind())
    box = obj = noobj = cls = 0.0
    for i in range(len(predictions)):
        b, o, n, c = yolo_loss(predictions[i], targets[i], scaled_anchors[i],
                               counts=counts[i])
        box, obj, noobj, cls = box + b, obj + o, noobj + n, cls + c
    total = box + obj + noobj + cls
    return total, {
        "box_loss": box,
        "obj_loss": obj,
        "no_obj_loss": noobj,
        "class_loss": cls,
    }
