"""Eval stack: accuracy counters, eval-box collection and mAP (counterpart
of ``yolo_for_turbines_tpu/train/evaluate.py``).

Every function takes the trainable module (``models/yolov3.py::YOLOv3``)
and runs on the device of its parameters; ``loader`` is any iterable of
``(images (B, S, S, 3), targets (3 arrays (B, A, S, S, 6)))``, numpy or
tensors, coarsest scale first. The forward runs in eval mode (the module's
mode is restored after it) and without gradients:

- ``compute_dtype=torch.bfloat16`` (the default, as in the JAX package) runs
  the float32 module under ``torch.autocast``;
- ``torch.float32`` runs it with TF32 off.

Per batch, one forward feeds the 3-scale decode and the fixed-shape
class-aware NMS, which launches K1 on CUDA (``ops/nms.py``); only the K
survivors per image and the top ``max_gt`` ground-truth rows of the finest
scale (real ground truth scores 1, empty cells 0) go on, to the host rows
or to the device mAP (``ops/map.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .. import config as cfg
from ..models.blocks import full_f32
from ..ops.decode import decode_all_scales, decode_scale
from ..ops.map import calc_map, calc_map_device_batched
from ..ops.nms import batched_nms
from .loss import total_yolo_loss


def _forward(model, images: torch.Tensor, compute_dtype, layout=None) -> List[torch.Tensor]:
    """The eval-mode heads (B, A, S, S, 5+C) f32 in ``compute_dtype``
    (on a mesh with ``layout``: ``models/yolov3.py::YOLOv3.forward``)."""
    was_training = model.training
    model.eval()
    try:
        if compute_dtype == torch.float32:
            with full_f32():
                return model(images, layout=layout)
        with torch.autocast(images.device.type, dtype=compute_dtype):
            return model(images, layout=layout)
    finally:
        model.train(was_training)


def _inputs(model, images, targets, anchors):
    """Batch and anchors on the module's device; the grid sizes."""
    dev = next(model.parameters()).device
    images = torch.as_tensor(images).to(dev)
    targets = [torch.as_tensor(t).to(dev) for t in targets]
    grid_sizes = cfg.grid_sizes_for(images.shape[1], model.strides)
    scaled = torch.as_tensor(np.asarray(anchors, np.float32), device=dev) * torch.tensor(
        grid_sizes, dtype=torch.float32, device=dev).reshape(-1, 1, 1)
    return images, targets, grid_sizes, scaled


def _top_ground_truth(targets_fine, scaled_fine, grid_size: int, max_gt: int):
    """The finest scale's target rows, top ``max_gt`` by objectness. A
    stable descending sort: equal scores keep their cell order, the tie rule
    of ``lax.top_k``."""
    true = decode_scale(targets_fine, scaled_fine, grid_size, is_pred=False)
    k = min(max_gt, true.shape[1])
    idx = torch.sort(true[..., 4], dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(true, 1, idx[..., None].expand(-1, -1, true.shape[-1]))


def make_eval_boxes_step(
    model,
    compute_dtype=torch.bfloat16,
    max_boxes: int = 256,
    max_gt: int = 128,
    obj_threshold: float = cfg.CONF_THRESHOLD,
    nms_iou_threshold: float = cfg.NMS_IOU_THRESHOLD,
):
    """fn(images, targets_fine, anchors) -> (kept (B, K, 6), mask (B, K),
    true (B, max_gt, 6)), on the module's device. ``anchors`` are the
    normalized (3, A, 2) anchors; ``targets_fine`` the finest scale's
    targets (parity with reference code/utils.py:311-315)."""

    @torch.no_grad()
    def eval_boxes_step(images, targets_fine, anchors):
        images, (targets_fine,), grid_sizes, scaled = _inputs(
            model, images, (targets_fine,), anchors)
        preds = _forward(model, images, compute_dtype)
        boxes = decode_all_scales(preds, scaled, grid_sizes)
        kept, mask = batched_nms(boxes, iou_threshold=nms_iou_threshold,
                                 obj_threshold=obj_threshold, max_boxes=max_boxes)
        true = _top_ground_truth(targets_fine, scaled[-1], grid_sizes[-1], max_gt)
        return kept, mask, true

    return eval_boxes_step


def make_fused_eval_step(
    model,
    object_threshold: float = cfg.CONF_THRESHOLD,
    compute_dtype=torch.bfloat16,
    max_boxes: int = 256,
    max_gt: int = 128,
    nms_iou_threshold: float = cfg.NMS_IOU_THRESHOLD,
):
    """fn(images, targets, anchors) -> (metrics, counts (6,), kept (B, K, 6),
    mask (B, K), true (B, max_gt, 6)) from ONE forward: the 4-term loss
    (``metrics``: the terms and "loss"), the accuracy counts, the NMS
    survivors and the top-k ground truth, all that a validation epoch's
    three consumers need."""

    @torch.no_grad()
    def fused_val_step(images, targets, anchors):
        images, targets, grid_sizes, scaled = _inputs(model, images, targets, anchors)
        preds = _forward(model, images, compute_dtype)
        total, comps = total_yolo_loss(preds, targets, scaled)
        metrics = dict(comps)
        metrics["loss"] = total
        counts = _accuracy_counts(preds, targets, object_threshold)
        boxes = decode_all_scales(preds, scaled, grid_sizes)
        kept, mask = batched_nms(boxes, iou_threshold=nms_iou_threshold,
                                 obj_threshold=object_threshold, max_boxes=max_boxes)
        true = _top_ground_truth(targets[-1], scaled[-1], grid_sizes[-1], max_gt)
        return metrics, counts, kept, mask, true

    return fused_val_step


def rows_from_eval_step(kept, mask, true, start_idx: int, obj_threshold: float):
    """One batch's eval output -> host prediction / GT rows [image_id, cx,
    cy, w, h, score, class] (the host-mAP input format)."""
    preds_rows: List[List[float]] = []
    true_rows: List[List[float]] = []
    kept, mask, true = (torch.as_tensor(t).cpu().numpy() for t in (kept, mask, true))
    idx = start_idx
    for b in range(kept.shape[0]):
        for row in kept[b][mask[b]]:
            preds_rows.append([idx] + row.tolist())
        tb = true[b]
        for row in tb[tb[:, 4] > obj_threshold]:
            true_rows.append([idx] + row.tolist())
        idx += 1
    return preds_rows, true_rows, idx


def get_eval_boxes(
    loader,
    model,
    anchors,
    obj_threshold: float = cfg.CONF_THRESHOLD,
    nms_iou_threshold: float = cfg.NMS_IOU_THRESHOLD,
    max_boxes: int = 256,
    compute_dtype=torch.bfloat16,
) -> Tuple[List[List[float]], List[List[float]]]:
    """Prediction and GT rows [image_id, cx, cy, w, h, score, class] over
    the loader (output parity with reference code/utils.py:276-332)."""
    step = make_eval_boxes_step(model, compute_dtype, max_boxes,
                                obj_threshold=obj_threshold,
                                nms_iou_threshold=nms_iou_threshold)
    all_preds: List[List[float]] = []
    all_true: List[List[float]] = []
    data_idx = 0
    for images, targets in loader:
        kept, mask, true = step(images, targets[-1], anchors)
        p_rows, t_rows, data_idx = rows_from_eval_step(kept, mask, true, data_idx,
                                                       obj_threshold)
        all_preds.extend(p_rows)
        all_true.extend(t_rows)
    return all_preds, all_true


def _accuracy_counts(preds, targets, object_threshold: float) -> torch.Tensor:
    """(6,) f32 class / obj / noobj correct counts and their totals
    (parity with reference code/utils.py:334-381)."""
    counts = torch.zeros(6, dtype=torch.float32, device=preds[0].device)
    for p, t in zip(preds, targets):
        obj = t[..., 4] == 1
        noobj = t[..., 4] == 0
        correct_class = (torch.argmax(p[..., 5:], dim=-1) == t[..., 5]) & obj
        obj_pred = torch.sigmoid(p[..., 4]) > object_threshold
        correct_obj = (obj_pred == obj) & obj
        correct_noobj = (obj_pred == obj) & noobj
        counts = counts + torch.stack([
            correct_class.sum(), obj.sum(), correct_obj.sum(),
            obj.sum(), correct_noobj.sum(), noobj.sum(),
        ]).float()
    return counts


@torch.no_grad()
def check_model_accuracy(loader, model, object_threshold: float = cfg.CONF_THRESHOLD,
                         compute_dtype=torch.bfloat16):
    """(class_acc, noobj_acc, obj_acc) over the loader (parity with
    reference code/utils.py:334-381)."""
    dev = next(model.parameters()).device
    totals = np.zeros(6)
    for images, targets in loader:
        preds = _forward(model, torch.as_tensor(images).to(dev), compute_dtype)
        targets = [torch.as_tensor(t).to(dev) for t in targets]
        totals += _accuracy_counts(preds, targets, object_threshold).cpu().numpy()
    class_acc = totals[0] / (totals[1] + 1e-16)
    obj_acc = totals[2] / (totals[3] + 1e-16)
    noobj_acc = totals[4] / (totals[5] + 1e-16)
    return float(class_acc), float(noobj_acc), float(obj_acc)


def evaluate_map(
    loader,
    model,
    anchors,
    num_classes: int,
    map_iou_threshold: float = cfg.MAP_IOU_THRESHOLD,
    compute_dtype=torch.bfloat16,
) -> float:
    """Boxes on the device, mAP on the host (``calc_map``)."""
    preds, trues = get_eval_boxes(loader, model, anchors, compute_dtype=compute_dtype)
    return calc_map(preds, trues, iou_threshold=map_iou_threshold,
                    box_format="center", num_classes=num_classes)


def evaluate_map_device(
    loader,
    model,
    anchors,
    num_classes: int,
    map_iou_threshold: float = cfg.MAP_IOU_THRESHOLD,
    obj_threshold: float = cfg.CONF_THRESHOLD,
    max_boxes: int = 256,
    max_gt: int = 128,
    compute_dtype=torch.bfloat16,
) -> float:
    """mAP with no boxes on the host: the survivors and ground truth of
    every batch stay on the device, bucketed by image, and
    ``calc_map_device_batched`` reduces them to one scalar (memory
    O(images * K * G), plus one (classes, images, G) tensor per step)."""
    step = make_eval_boxes_step(model, compute_dtype, max_boxes, max_gt,
                                obj_threshold=obj_threshold)
    pred_rows, pred_ok, true_rows, true_ok = [], [], [], []
    for images, targets in loader:
        kept, mask, true = step(images, targets[-1], anchors)
        pred_rows.append(kept)
        pred_ok.append(mask)
        true_rows.append(true)
        true_ok.append(true[..., 4] > obj_threshold)
    m = calc_map_device_batched(
        torch.cat(pred_rows), torch.cat(pred_ok), torch.cat(true_rows), torch.cat(true_ok),
        iou_threshold=map_iou_threshold, num_classes=num_classes)
    return float(m)
