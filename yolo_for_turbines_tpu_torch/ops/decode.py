"""Cells -> boxes decode on torch tensors (counterpart of ``ops/decode.py``).

Every function returns ``(B, N, 6)`` float32 rows ``[cx, cy, w, h, score,
class]`` in normalized image coordinates. Anchors come pre-scaled by the
grid size (cell units).

- ``decode_scale`` / ``decode_all_scales`` read the reference's head layout
  ``(B, A, S, S, 5+C)`` (the trainable module's output), anchor-major, or
  with ``is_pred=False`` the encoded target grids ``(B, A, S, S, 6)``;
- ``decode_raw_scale`` / ``decode_raw_all`` read the folded model's raw NHWC
  heads ``(B, S, S, A*(5+C))``, cells-major (the JAX ``decode_raw_scale``
  order): box math in f32, the class argmax in the head's dtype. A scale's
  ``scale_xy`` (YOLOv4's grid-sensitive decode, darknet's ``scale_x_y``)
  stretches the cell offset: ``sigmoid(t) * scale_xy - (scale_xy - 1) / 2``;
  at 1.0 (YOLOv3) no op is added. A scale's ``size_decode`` reads the size
  logits as ``exp(t) * anchor`` (``"exp"``: YOLOv3, YOLOv4) or as ``(2
  sigmoid(t))^2 * anchor`` (``"square"``: YOLOv7).
"""

from __future__ import annotations

import torch


def decode_scale(predictions, anchors, grid_size: int, is_pred: bool = True) -> torch.Tensor:
    """Decode one scale's raw predictions (sigmoid / exp applied) or, with
    ``is_pred=False``, its encoded targets."""
    predictions = torch.as_tensor(predictions)
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=predictions.device)
    b, a, s = predictions.shape[0], anchors.shape[0], grid_size

    if is_pred:
        xy = torch.sigmoid(predictions[..., 0:2])
        wh = torch.exp(predictions[..., 2:4]) * anchors.reshape(1, a, 1, 1, 2)
        scores = torch.sigmoid(predictions[..., 4:5])
        best_class = torch.argmax(predictions[..., 5:], dim=-1)[..., None].to(predictions.dtype)
    else:
        xy = predictions[..., 0:2]
        wh = predictions[..., 2:4]
        scores = predictions[..., 4:5]
        best_class = predictions[..., 5:6]

    ar = torch.arange(s, dtype=predictions.dtype, device=predictions.device)
    # cell index j runs along axis 3 (x), i along axis 2 (y)
    cx = (xy[..., 0:1] + ar[None, None, None, :, None]) / s
    cy = (xy[..., 1:2] + ar[None, None, :, None, None]) / s
    wh = wh / s

    boxes = torch.cat([cx, cy, wh, scores, best_class], dim=-1)
    return boxes.reshape(b, a * s * s, 6).float()


def cells_to_boxes(predictions, anchors, grid_size: int, is_pred: bool = True):
    """Reference-shaped API: nested Python lists (B, 3*S*S, 6)."""
    return decode_scale(predictions, anchors, grid_size, is_pred).tolist()


def decode_all_scales(predictions, scaled_anchors, grid_sizes) -> torch.Tensor:
    """Decode and concatenate the scales' heads (stride-32 first):
    (B, sum(A*S*S), 6)."""
    parts = [
        decode_scale(p, scaled_anchors[i], grid_sizes[i], is_pred=True)
        for i, p in enumerate(predictions)
    ]
    return torch.cat(parts, dim=1)


def decode_raw_scale(raw: torch.Tensor, anchors: torch.Tensor, grid_size: int,
                     num_classes: int, scale_xy: float = 1.0,
                     size_decode: str = "exp") -> torch.Tensor:
    """Decode one scale's raw NHWC head output."""
    b, s = raw.shape[0], grid_size
    anchors = torch.as_tensor(anchors, device=raw.device).to(raw.dtype)
    a = anchors.shape[0]
    y = raw.reshape(b, s, s, a, 5 + num_classes)

    ar = torch.arange(s, dtype=torch.float32, device=raw.device)
    box = y[..., 0:5].float()
    ox, oy = torch.sigmoid(box[..., 0:1]), torch.sigmoid(box[..., 1:2])
    if scale_xy != 1.0:
        shift = 0.5 * (scale_xy - 1.0)
        ox, oy = ox * scale_xy - shift, oy * scale_xy - shift
    cx = (ox + ar[None, None, :, None, None]) / s
    cy = (oy + ar[None, :, None, None, None]) / s
    if size_decode == "exp":
        size = torch.exp(box[..., 2:4])
    elif size_decode == "square":
        size = (torch.sigmoid(box[..., 2:4]) * 2).square()
    else:
        raise ValueError(f"unknown size decode {size_decode!r}")
    wh = size * anchors.float().reshape(1, 1, 1, a, 2) / s
    scores = torch.sigmoid(box[..., 4:5])
    best_class = torch.argmax(y[..., 5:], dim=-1)[..., None].float()
    boxes = torch.cat([cx, cy, wh, scores, best_class], dim=-1)
    return boxes.reshape(b, s * s * a, 6)


def decode_raw_all(raw_preds, scaled_anchors, grid_sizes, num_classes: int,
                   scale_xy=None, size_decode=None):
    """Raw-head decode over all scales -> (B, sum(S*S*A), 6); ``scale_xy``
    one factor per scale, or None for 1.0 at every scale; ``size_decode``
    one mode per scale, or None for ``"exp"`` at every scale."""
    scale_xy = scale_xy or (1.0,) * len(raw_preds)
    size_decode = size_decode or ("exp",) * len(raw_preds)
    parts = [
        decode_raw_scale(r, scaled_anchors[i], grid_sizes[i], num_classes, scale_xy[i],
                         size_decode[i])
        for i, r in enumerate(raw_preds)
    ]
    return torch.cat(parts, dim=1)
