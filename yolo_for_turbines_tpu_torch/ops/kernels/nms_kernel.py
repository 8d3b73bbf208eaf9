"""Fused greedy NMS (kernel K1, ``csrc/nms.cu``) and its plain torch version.

Counterpart of ``yolo_for_turbines_tpu/ops/pallas/nms_kernel.py``. The input
is the top-K candidates per image sorted by descending score; the output is
the (B, K) keep mask of class-aware greedy NMS, in which a box cleared by an
earlier kept box no longer suppresses anyone (reference: code/utils.py:150-191).

``greedy_nms`` dispatches on the tensor's device: a CPU tensor takes
``greedy_nms_reference``; a CUDA tensor launches the kernel or raises. The
kernel reads the candidates as they are (it converts center boxes itself,
with ``_top_left``'s floats) and takes any K: one launch up to
``FUSED_MAX_K`` candidates, with the suppression bits in shared memory, and
two launches beyond, with the bits in a scratch tensor allocated here.
"""

from __future__ import annotations

import torch

from ..iou import calc_iou
from . import check, load_library, stream_handle

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0

FUSED_MAX_K = 1024  # csrc/nms.cu's kFusedMaxK: K x K/32 bit words fit shared memory


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
    out = torch.empty((b, k), dtype=torch.bool, device=cand.device)
    if b == 0 or k == 0:
        return out
    # the serving path hands over f32 and bool, contiguous: nothing runs
    # before the launch, and the host does as little as it can
    cand_f = cand if cand.dtype == torch.float32 and cand.is_contiguous() \
        else cand.float().contiguous()
    valid_b = valid if valid.dtype == torch.bool and valid.is_contiguous() \
        else valid.to(torch.bool).contiguous()
    if cand_f.data_ptr() % 8:
        raise ValueError("greedy_nms: cand must be 8-byte aligned")
    fused = k <= FUSED_MAX_K
    bits = None
    if not fused:
        if b > 65535:
            raise ValueError(f"greedy_nms: K={k} > {FUSED_MAX_K} takes at most 65535 images")
        bits = torch.empty((b, k, (k + 31) // 32), dtype=torch.int32, device=cand.device)
    rc = load_library().greedy_nms_launch(
        cand_f.data_ptr(), valid_b.data_ptr(), float(iou_threshold), b, k,
        int(box_format == "center"), None if fused else bits.data_ptr(), out.data_ptr(),
        stream_handle(cand.device),
    )
    check(rc, "greedy_nms_launch")
    launches += 1 if fused else 2
    return out
