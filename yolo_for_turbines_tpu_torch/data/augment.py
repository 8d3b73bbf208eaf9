"""Letterbox geometry in numpy + PIL: a jax-free copy of the serving part of
``yolo_for_turbines_tpu/data/augment.py`` (whose package imports jax).

LongestMaxSize + center pad to (size, size), and the inverse map of boxes
back to the original frame (reference: code/utils.py:475-501).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def resize_longest(img: np.ndarray, size: int) -> np.ndarray:
    """Resize so the longest side equals `size`, keeping aspect ratio."""
    from PIL import Image

    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    if (nh, nw) == (h, w):
        return img
    return np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))


def pad_center(
    img: np.ndarray, min_h: int, min_w: int, fill: int = 0
) -> Tuple[np.ndarray, int, int]:
    """Center-pad to at least (min_h, min_w). Returns (img, pad_top, pad_left)."""
    h, w = img.shape[:2]
    pad_h, pad_w = max(0, min_h - h), max(0, min_w - w)
    top, left = pad_h // 2, pad_w // 2
    if pad_h == 0 and pad_w == 0:
        return img, 0, 0
    out = np.full((h + pad_h, w + pad_w) + img.shape[2:], fill, dtype=img.dtype)
    out[top : top + h, left : left + w] = img
    return out, top, left


def letterbox_box_geometry(h0: int, w0: int, size: int) -> Tuple[int, int, int, int]:
    """(nh, nw, top, left) of a letterbox from (h0, w0) to (size, size)."""
    scale = size / max(h0, w0)
    nh, nw = max(1, round(h0 * scale)), max(1, round(w0 * scale))
    return nh, nw, (size - nh) // 2, (size - nw) // 2


def letterbox_boxes(boxes: np.ndarray, h0: int, w0: int, size: int) -> np.ndarray:
    """Box-only letterbox transform (same mapping `letterbox` applies)."""
    nh, nw, top, left = letterbox_box_geometry(h0, w0, size)
    boxes = np.asarray(boxes, np.float64).copy()
    if len(boxes):
        boxes[:, 0] = (boxes[:, 0] * nw + left) / size
        boxes[:, 1] = (boxes[:, 1] * nh + top) / size
        boxes[:, 2] = boxes[:, 2] * nw / size
        boxes[:, 3] = boxes[:, 3] * nh / size
    return boxes


def letterbox(
    img: np.ndarray, boxes: Optional[np.ndarray], size: int, fill: int = 0
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """LongestMaxSize + center pad to (size, size); adjusts normalized boxes."""
    h0, w0 = img.shape[:2]
    img = resize_longest(img, size)
    img, _, _ = pad_center(img, size, size, fill)
    if boxes is not None and len(boxes):
        boxes = letterbox_boxes(boxes, h0, w0, size)
    return img, boxes


def unletterbox_boxes(
    boxes: Sequence[Sequence[float]], original_hw: Tuple[int, int],
    resized_hw: Tuple[int, int],
) -> List[List[float]]:
    """Map normalized letterboxed boxes back to the original image frame."""
    o_h, o_w = original_hw
    r_h, r_w = resized_hw
    scale = min(r_w / o_w, r_h / o_h)
    new_w, new_h = int(o_w * scale), int(o_h * scale)
    pad_w, pad_h = (r_w - new_w) // 2, (r_h - new_h) // 2
    out = []
    for box in boxes:
        out.append(
            [
                (box[0] * r_w - pad_w) / new_w,
                (box[1] * r_h - pad_h) / new_h,
                box[2] * r_w / new_w,
                box[3] * r_h / new_h,
            ]
            + list(box[4:])
        )
    return out
