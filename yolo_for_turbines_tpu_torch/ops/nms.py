"""Class-aware greedy NMS with fixed shapes (counterpart of ``ops/nms.py``).

1. pre-filter score > obj_threshold (strict, parity with reference
   code/utils.py:165) and take the top K = max_boxes candidates by score,
   descending (``torch.topk`` on scores masked to -inf);
2. greedy suppression over those K: a same-class later box with IoU >= the
   threshold is cleared by a kept box, and a cleared box no longer
   suppresses (``ops/kernels/nms_kernel.py``).

CUDA tensors run step 2 in the fused kernel at every batch size and every
K (``max_boxes`` may be the number of candidates, as a reference-style
``non_max_suppression`` asks); CPU tensors take its plain torch version,
and so does every device with ``portable=True`` (the hermetic serve module
of ``serving.py``, which carries no kernel).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .kernels.nms_kernel import greedy_nms, greedy_nms_reference


def _top_k_candidates(boxes: torch.Tensor, obj_threshold: float, max_boxes: int):
    k = min(max_boxes, boxes.shape[1])
    scores = boxes[..., 4]
    valid = scores > obj_threshold
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    top_scores, top_idx = torch.topk(masked, k, dim=-1, sorted=True)
    cand = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, boxes.shape[-1]))
    return cand, top_scores > obj_threshold


def batched_nms(boxes: torch.Tensor, iou_threshold: float, obj_threshold: float,
                max_boxes: int = 256, box_format: str = "center", portable: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 6) [cx, cy, w, h, score, class] -> ((B, K, 6), (B, K) bool).

    Rows are sorted by descending score; rows whose mask is False are
    padding or suppressed. ``portable`` takes the plain sweep on every
    device (bit-identical to the kernel)."""
    cand, valid = _top_k_candidates(boxes, obj_threshold, max_boxes)
    nms = greedy_nms_reference if portable else greedy_nms
    return cand, nms(cand, valid, iou_threshold, box_format=box_format)


def nms_single(boxes: torch.Tensor, iou_threshold: float, obj_threshold: float,
               max_boxes: int = 256, box_format: str = "center"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS for one image's (N, 6) candidates -> ((K, 6), (K,) bool)."""
    kept, keep = batched_nms(boxes[None], iou_threshold, obj_threshold,
                             max_boxes, box_format)
    return kept[0], keep[0]


def non_max_suppression(boxes, iou_threshold: float, obj_threshold: float,
                        box_format: str = "corners") -> List[List[float]]:
    """The reference's list API (reference: code/utils.py:150-191): a list
    of [x, y, w, h, score, class] rows in, the surviving rows out, sorted by
    descending score. Runs ``nms_single`` over every row on the CPU (K = the
    row count); for host-side use, not for serving."""
    arr = np.asarray(boxes, dtype=np.float32)
    if arr.size == 0:
        return []
    kept, mask = nms_single(torch.from_numpy(arr.reshape(-1, 6)), iou_threshold=iou_threshold,
                            obj_threshold=obj_threshold, max_boxes=arr.shape[0],
                            box_format=box_format)
    return nms_to_list(kept, mask)


def nms_to_list(kept_boxes, keep_mask) -> List[List[float]]:
    """(K, 6) + (K,) -> reference-style list of [x, y, w, h, score, class]."""
    if isinstance(kept_boxes, torch.Tensor):
        kept_boxes = kept_boxes.cpu().numpy()
    if isinstance(keep_mask, torch.Tensor):
        keep_mask = keep_mask.cpu().numpy()
    kept = np.asarray(kept_boxes)
    mask = np.asarray(keep_mask)
    return [row.tolist() for row in kept[mask]]
