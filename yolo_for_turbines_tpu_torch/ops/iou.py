"""Broadcast IoU on torch tensors (counterpart of ``ops/iou.py``:
``calc_iou`` and ``iou_aligned``).

``box_format="center"`` takes cxcywh; any other value takes top-left xywh
(the reference's "corners" branch treats boxes as (x_tl, y_tl, w, h)). The
denominator has +1e-6. Operation order follows the JAX function.
"""

from __future__ import annotations

import torch


def iou_aligned(box1, box2) -> torch.Tensor:
    """IoU of (..., 2) [w, h] boxes aligned at their centres, broadcast."""
    box1, box2 = torch.as_tensor(box1), torch.as_tensor(box2)
    inter = torch.minimum(box1[..., 0], box2[..., 0]) * torch.minimum(box1[..., 1], box2[..., 1])
    union = box1[..., 0] * box1[..., 1] + box2[..., 0] * box2[..., 1] - inter
    return inter / union


def calc_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, box_format: str = "center"):
    """(..., 4) x (..., 4) -> broadcast IoU."""
    if box_format == "center":
        b1_xy = boxes1[..., :2] - boxes1[..., 2:4] / 2
        b2_xy = boxes2[..., :2] - boxes2[..., 2:4] / 2
    else:
        b1_xy = boxes1[..., :2]
        b2_xy = boxes2[..., :2]
    b1_wh = boxes1[..., 2:4]
    b2_wh = boxes2[..., 2:4]

    xa = torch.maximum(b1_xy[..., 0], b2_xy[..., 0])
    ya = torch.maximum(b1_xy[..., 1], b2_xy[..., 1])
    xb = torch.minimum(b1_xy[..., 0] + b1_wh[..., 0], b2_xy[..., 0] + b2_wh[..., 0])
    yb = torch.minimum(b1_xy[..., 1] + b1_wh[..., 1], b2_xy[..., 1] + b2_wh[..., 1])

    inter = torch.clamp(xb - xa, min=0) * torch.clamp(yb - ya, min=0)
    area1 = b1_wh[..., 0] * b1_wh[..., 1]
    area2 = b2_wh[..., 0] * b2_wh[..., 1]
    return inter / (area1 + area2 - inter + 1e-6)
