"""Fused greedy NMS (kernel K1, ``csrc/nms.cu``) and its plain torch version.

Counterpart of ``yolo_for_turbines_tpu/ops/pallas/nms_kernel.py``. The input
is the top-K candidates per image sorted by descending score; the output is
the (B, K) keep mask of class-aware greedy NMS, in which a box cleared by an
earlier kept box no longer suppresses anyone (reference: code/utils.py:150-191).

``greedy_nms`` dispatches on the tensor's device: a CPU tensor takes
``greedy_nms_reference``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..iou import calc_iou
from . import check, load_library, stream_handle

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0

MAX_K = 1024  # one thread per candidate in a single CTA


def _top_left(boxes4: torch.Tensor, box_format: str) -> torch.Tensor:
    """(..., 4) f32 boxes -> top-left xywh (same floats for kernel and plain)."""
    if box_format == "center":
        xy = boxes4[..., :2] - boxes4[..., 2:4] / 2
        return torch.cat([xy, boxes4[..., 2:4]], dim=-1)
    return boxes4


def greedy_nms_reference(cand, valid, iou_threshold: float,
                         box_format: str = "center") -> torch.Tensor:
    """Plain torch version: full K x K suppression matrix, then a K-step sweep
    in the operation order of the Pallas ``_nms_kernel``."""
    boxes = _top_left(cand[..., :4].float(), box_format)
    cls = cand[..., 5].float()
    k = cand.shape[1]

    # i indexes rows (the suppressor), j columns (the candidate)
    iou = calc_iou(boxes[:, :, None, :], boxes[:, None, :, :], "top_left")
    same = cls[:, :, None] == cls[:, None, :]
    later = torch.ones(k, k, dtype=torch.bool, device=cand.device).triu(1)
    suppress = same & (iou >= iou_threshold) & later

    keep = valid.to(torch.bool).clone()
    for i in range(k):
        keep &= ~(suppress[:, i, :] & keep[:, i : i + 1])
    return keep


def greedy_nms(cand, valid, iou_threshold: float,
               box_format: str = "center") -> torch.Tensor:
    """Greedy NMS over pre-sorted candidates.

    Args:
        cand: (B, K, 6) top-K candidates per image, descending score.
        valid: (B, K) bool candidate validity (score above threshold).
        iou_threshold: suppress same-class later boxes with IoU >= this.
        box_format: "center" (cxcywh) or top-left xywh otherwise.

    Returns:
        (B, K) bool keep mask.
    """
    global launches
    if cand.device.type == "cpu":
        return greedy_nms_reference(cand, valid, iou_threshold, box_format)
    if cand.device.type != "cuda":
        raise ValueError(f"greedy_nms: unsupported device {cand.device}")
    if cand.dim() != 3 or cand.shape[-1] != 6:
        raise ValueError(f"greedy_nms: cand must be (B, K, 6), got {tuple(cand.shape)}")
    b, k = cand.shape[0], cand.shape[1]
    if tuple(valid.shape) != (b, k) or valid.device != cand.device:
        raise ValueError("greedy_nms: valid must be a (B, K) tensor on cand's device")
    if k > MAX_K:
        raise ValueError(f"greedy_nms: K={k} exceeds the kernel's limit of {MAX_K}")
    out = torch.empty((b, k), dtype=torch.bool, device=cand.device)
    if b == 0 or k == 0:
        return out
    boxes = _top_left(cand[..., :4].float(), box_format).contiguous()
    cls = cand[..., 5].float().contiguous()
    valid_b = valid.to(torch.bool).contiguous()
    if boxes.data_ptr() % 16:
        raise ValueError("greedy_nms: boxes must be 16-byte aligned")
    lib = load_library()
    rc = lib.greedy_nms_launch(
        boxes.data_ptr(), cls.data_ptr(), valid_b.data_ptr(),
        float(iou_threshold), b, k, out.data_ptr(), stream_handle(cand.device),
    )
    check(rc, "greedy_nms_launch")
    launches += 1
    return out
