"""Plain decode, greedy NMS, letterbox and box matching: the benchmark's
reference for what follows the forward.

- :func:`decode` turns raw NHWC heads into ``[cx, cy, w, h, score, class]``
  rows in the letterboxed frame: sigmoid offsets plus the cell, exp sizes
  times the anchor, sigmoid objectness, argmax class (YOLOv3, arXiv:1804.02767,
  section 2.1), cells-major (row, column, anchor).
- :func:`nms` keeps the ``max_boxes`` best rows whose score is above the
  threshold, by descending score, then clears every later row of the same
  class whose IoU with a kept row is at least the threshold; a cleared row
  clears nothing.
- :func:`letterbox` resizes the longest side to the model's size (PIL,
  bilinear, sizes rounded half to even) and pads the rest with 0 around the
  centre; :func:`unletterbox` maps boxes back to the source frame as the
  detector's demo does (scale from ``min`` of the two ratios, sizes
  truncated).
- :func:`mismatch` counts the boxes of two sets that have no partner in the
  other set: the same class, the centre and score within ``POSITION_TOL``
  and the sizes within ``SIZE_TOL`` of theirs.

It imports nothing of the measured program.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
from PIL import Image


def decode(heads: Sequence[torch.Tensor], anchors, num_classes: int,
           dtype=torch.float32) -> torch.Tensor:
    """(B, sum(S * S * A), 6) float32 from raw NHWC heads, coarsest first;
    ``anchors`` (scales, A, 2) normalised to the image; the box arithmetic
    in ``dtype`` (bfloat16 for the control of what follows the forward)."""
    rows = []
    for raw, anc in zip(heads, anchors):
        b, s = raw.shape[0], raw.shape[1]
        a = len(anc)
        y = raw.to(dtype).reshape(b, s, s, a, 5 + num_classes)
        grid = torch.arange(s, dtype=dtype, device=raw.device)
        anc = torch.as_tensor(np.asarray(anc, np.float32), device=raw.device).to(dtype)
        cx = (torch.sigmoid(y[..., 0]) + grid[None, None, :, None]) / s
        cy = (torch.sigmoid(y[..., 1]) + grid[None, :, None, None]) / s
        w = torch.exp(y[..., 2]) * anc[:, 0]
        h = torch.exp(y[..., 3]) * anc[:, 1]
        score = torch.sigmoid(y[..., 4])
        cls = torch.argmax(y[..., 5:], dim=-1).to(dtype)
        rows.append(torch.stack([cx, cy, w, h, score, cls], -1).reshape(b, -1, 6).float())
    return torch.cat(rows, 1)


def iou_center(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of centre-format boxes, broadcast; 1e-6 in the denominator."""
    ax0, ay0 = a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2
    bx0, by0 = b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2
    iw = (torch.minimum(ax0 + a[..., 2], bx0 + b[..., 2]) - torch.maximum(ax0, bx0)).clamp(min=0)
    ih = (torch.minimum(ay0 + a[..., 3], by0 + b[..., 3]) - torch.maximum(ay0, by0)).clamp(min=0)
    inter = iw * ih
    return inter / (a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter + 1e-6)


def nms(rows: torch.Tensor, score_threshold: float, iou_threshold: float, max_boxes: int):
    """Class-aware greedy NMS over each image's best ``max_boxes`` rows:
    ((B, K, 6) candidates by descending score, (B, K) bool kept)."""
    k = min(max_boxes, rows.shape[1])
    score = rows[..., 4]
    masked = torch.where(score > score_threshold, score, torch.full_like(score, -1.0))
    order = torch.argsort(masked, dim=1, descending=True, stable=True)[:, :k]
    cand = torch.gather(rows, 1, order[..., None].expand(-1, -1, 6))
    valid = torch.gather(masked, 1, order) > score_threshold
    keep = torch.zeros_like(valid)
    cleared = torch.zeros_like(valid)
    later = torch.arange(k, device=rows.device)
    for i in range(k):
        alive = valid[:, i] & ~cleared[:, i]
        keep[:, i] = alive
        hit = (iou_center(cand[:, i : i + 1, :4], cand[..., :4]) >= iou_threshold) \
            & (cand[..., 5] == cand[:, i : i + 1, 5]) & (later > i)
        cleared |= alive[:, None] & hit
    return cand, keep


def kept_rows(cand: torch.Tensor, keep: torch.Tensor) -> List[np.ndarray]:
    """Each image's kept rows as a float64 numpy array."""
    cand, keep = cand.double().cpu().numpy(), keep.cpu().numpy()
    return [c[m] for c, m in zip(cand, keep)]


def letterbox(img: np.ndarray, size: int) -> np.ndarray:
    """(size, size, 3) float32 in [0, 1] from an HWC uint8 image."""
    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    if (nh, nw) != (h, w):
        img = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
    out = np.zeros((size, size, 3), np.uint8)
    top, left = (size - nh) // 2, (size - nw) // 2
    out[top : top + nh, left : left + nw] = img
    return out.astype(np.float32) / 255.0


def unletterbox(rows: np.ndarray, hw, size: int) -> np.ndarray:
    """Rows in the letterboxed frame -> the source image's normalised frame."""
    h, w = hw
    scale = min(size / w, size / h)
    nw, nh = int(w * scale), int(h * scale)
    pw, ph = (size - nw) // 2, (size - nh) // 2
    out = np.array(rows, np.float64).reshape(-1, 6)
    out[:, 0] = (out[:, 0] * size - pw) / nw
    out[:, 1] = (out[:, 1] * size - ph) / nh
    out[:, 2] = out[:, 2] * size / nw
    out[:, 3] = out[:, 3] * size / nh
    return out


# partners: cx, cy and score within POSITION_TOL, w and h within SIZE_TOL of
# their size. The sizes' room is the program's: its decode scales the anchors
# in the heads' dtype (bf16 rounds them by up to 2^-8 of their size).
POSITION_TOL = 1e-5
SIZE_TOL = 1e-2


def _unmatched(a: np.ndarray, b: np.ndarray) -> int:
    if len(a) == 0 or len(b) == 0:
        return len(a)
    d = np.abs(a[:, None, :] - b[None, :, :])
    size = np.maximum(np.abs(b[None, :, 2:4]), 1e-12)
    near = (d[..., [0, 1, 4]] <= POSITION_TOL).all(-1) & (d[..., 2:4] <= SIZE_TOL * size).all(-1) \
        & (d[..., 5] == 0)
    return int((~near.any(1)).sum())


def mismatch(got: Sequence[np.ndarray], want: Sequence[np.ndarray]):
    """(boxes without a partner in the other set, boxes in both sets), over
    images."""
    bad = total = 0
    for g, w in zip(got, want):
        bad += _unmatched(g, w) + _unmatched(w, g)
        total += len(g) + len(w)
    return bad, total
