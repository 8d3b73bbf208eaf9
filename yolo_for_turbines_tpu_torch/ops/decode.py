"""Raw-head decode on torch tensors (counterpart of ``ops/decode.py``).

Consumes the model's raw NHWC heads ``(B, S, S, A*(5+C))`` and returns
``(B, S*S*A, 6)`` float32 rows ``[cx, cy, w, h, score, class]`` in
normalized image coordinates, cells-major (the JAX ``decode_raw_scale``
order). Box math runs in f32; the class argmax stays in the head's dtype.
Anchors come pre-scaled by the grid size.
"""

from __future__ import annotations

import torch


def decode_raw_scale(raw: torch.Tensor, anchors: torch.Tensor, grid_size: int,
                     num_classes: int) -> torch.Tensor:
    """Decode one scale's raw NHWC head output."""
    b, s = raw.shape[0], grid_size
    anchors = torch.as_tensor(anchors, device=raw.device).to(raw.dtype)
    a = anchors.shape[0]
    y = raw.reshape(b, s, s, a, 5 + num_classes)

    ar = torch.arange(s, dtype=torch.float32, device=raw.device)
    box = y[..., 0:5].float()
    cx = (torch.sigmoid(box[..., 0:1]) + ar[None, None, :, None, None]) / s
    cy = (torch.sigmoid(box[..., 1:2]) + ar[None, :, None, None, None]) / s
    wh = torch.exp(box[..., 2:4]) * anchors.float().reshape(1, 1, 1, a, 2) / s
    scores = torch.sigmoid(box[..., 4:5])
    best_class = torch.argmax(y[..., 5:], dim=-1)[..., None].float()
    boxes = torch.cat([cx, cy, wh, scores, best_class], dim=-1)
    return boxes.reshape(b, s * s * a, 6)


def decode_raw_all(raw_preds, scaled_anchors, grid_sizes, num_classes: int):
    """Raw-head decode over all scales -> (B, sum(S*S*A), 6)."""
    parts = [
        decode_raw_scale(r, scaled_anchors[i], grid_sizes[i], num_classes)
        for i, r in enumerate(raw_preds)
    ]
    return torch.cat(parts, dim=1)
