"""Pairwise IoU matrix (kernel K3, ``csrc/iou.cu``) and its plain torch
version.

Counterpart of ``yolo_for_turbines_tpu/ops/pallas/iou_kernel.py``: (K, 4)
boxes -> (K, K) f32 IoU, ``inter / (union + 1e-6)``, with box_format
"center" (cxcywh) or top-left xywh otherwise. As in the JAX package no
serving path calls it (greedy NMS computes its IoUs inline); it stands
beside ``ops/iou.py`` as an op of its own.

``pairwise_iou`` dispatches on the tensor's device: a CPU tensor takes
``pairwise_iou_reference`` (after ``_top_left``); a CUDA tensor launches the
kernel, which converts center boxes itself with ``_top_left``'s floats, or
raises. The kernel writes 16-byte stores when K % 4 == 0 and scalar stores
otherwise (``vector_stores``; the C launcher decides from K alone).
"""

from __future__ import annotations

import torch

from . import check, load_library, stream_handle
from .nms_kernel import _top_left

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0


def pairwise_iou_reference(tl: torch.Tensor) -> torch.Tensor:
    """Plain torch version over top-left (K, 4) f32 boxes, in the operation
    order of the Pallas ``_iou_tile_kernel`` (rows i, columns j)."""
    x1i, y1i, wi, hi = (tl[:, None, d] for d in range(4))
    x1j, y1j, wj, hj = (tl[None, :, d] for d in range(4))
    xa = torch.maximum(x1i, x1j)
    ya = torch.maximum(y1i, y1j)
    xb = torch.minimum(x1i + wi, x1j + wj)
    yb = torch.minimum(y1i + hi, y1j + hj)
    zero = torch.zeros((), dtype=tl.dtype, device=tl.device)
    inter = torch.maximum(xb - xa, zero) * torch.maximum(yb - ya, zero)
    union = wi * hi + wj * hj - inter
    return inter / (union + 1e-6)


def vector_stores(k: int) -> bool:
    """Whether the kernel writes a (K, K) matrix with 16-byte stores: its
    rows are 16-byte aligned only when K % 4 == 0 (``csrc/iou.cu``'s
    launcher tests the same)."""
    return k % 4 == 0


def pairwise_iou(boxes4: torch.Tensor, box_format: str = "center") -> torch.Tensor:
    """(K, 4) boxes -> (K, K) f32 IoU matrix."""
    global launches
    if boxes4.dim() != 2 or boxes4.shape[-1] != 4:
        raise ValueError(f"pairwise_iou: boxes must be (K, 4), got {tuple(boxes4.shape)}")
    boxes = boxes4.float().contiguous()
    if boxes.device.type == "cpu":
        return pairwise_iou_reference(_top_left(boxes, box_format))
    if boxes.device.type != "cuda":
        raise ValueError(f"pairwise_iou: unsupported device {boxes.device}")
    k = boxes.shape[0]
    out = torch.empty((k, k), dtype=torch.float32, device=boxes.device)
    if k == 0:
        return out
    if boxes.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("pairwise_iou: boxes and output must be 16-byte aligned")
    rc = load_library().pairwise_iou_launch(
        boxes.data_ptr(), k, int(box_format == "center"), out.data_ptr(),
        stream_handle(boxes.device))
    check(rc, "pairwise_iou_launch")
    launches += 1
    return out
