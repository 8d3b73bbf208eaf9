"""Anchor-target assignment in numpy: a copy of ``_iou_wh`` and
``assign_targets`` of ``yolo_for_turbines_tpu/data/dataset.py`` (whose
package imports jax).

Per box: rank all 9 anchors by wh-IoU, descending; assign the best *free*
anchor of each scale (cell = (int(S*y), int(S*x))), storing
``[x_cell, y_cell, w*S, h*S, 1, class]``; mark obj = -1 ("ignore") for
non-best anchors with IoU > the threshold whose cell slot is free
(reference: code/dataset.py:129-161). The loss and the eval step read
these grids.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _iou_wh(box_wh: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """wh-IoU of one box against (N, 2) anchors, centres aligned."""
    inter = np.minimum(box_wh[0], anchors[:, 0]) * np.minimum(box_wh[1], anchors[:, 1])
    union = box_wh[0] * box_wh[1] + anchors[:, 0] * anchors[:, 1] - inter
    return inter / union


def assign_targets(
    boxes: Sequence[Sequence[float]],
    anchors: np.ndarray,
    grid_sizes: Sequence[int],
    ignore_iou_threshold: float = 0.5,
) -> List[np.ndarray]:
    """Encode yolo boxes into per-scale target grids.

    Args:
        boxes: (M, 5) normalized [cx, cy, w, h, class].
        anchors: (9, 2) normalized anchors, scales concatenated, stride-32
            anchors first.
        grid_sizes: (S0, S1, S2).
        ignore_iou_threshold: non-best anchors above this get obj=-1.

    Returns:
        list of 3 float32 arrays (3, S, S, 6): [x_cell, y_cell, w_cell,
        h_cell, obj, class].
    """
    num_per_scale = len(anchors) // len(grid_sizes)
    targets = [np.zeros((num_per_scale, s, s, 6), np.float32) for s in grid_sizes]
    for box in boxes:
        x, y, w, h, class_label = box
        ious = _iou_wh(np.asarray([w, h], np.float64), anchors)
        anchor_indices = np.argsort(-ious, kind="stable")
        has_anchor = [False] * len(grid_sizes)
        for anchor_idx in anchor_indices:
            scale_idx = int(anchor_idx) // num_per_scale
            anchor_for_scale = int(anchor_idx) % num_per_scale
            s = grid_sizes[scale_idx]
            i, j = int(s * y), int(s * x)
            i, j = min(i, s - 1), min(j, s - 1)  # guard cx/cy == 1.0 edge
            # -1 (ignore) counts as taken, as in the original
            anchor_taken = targets[scale_idx][anchor_for_scale, i, j, 4]
            if not anchor_taken and not has_anchor[scale_idx]:
                x_cell, y_cell = s * x - j, s * y - i
                targets[scale_idx][anchor_for_scale, i, j, :4] = (
                    x_cell,
                    y_cell,
                    w * s,
                    h * s,
                )
                targets[scale_idx][anchor_for_scale, i, j, 4] = 1
                targets[scale_idx][anchor_for_scale, i, j, 5] = int(class_label)
                has_anchor[scale_idx] = True
            elif not anchor_taken and ious[anchor_idx] > ignore_iou_threshold:
                targets[scale_idx][anchor_for_scale, i, j, 4] = -1
    return targets
