"""K-means / k-means++ anchor generation (first-class module + CLI).

The port's own copy of ``yolo_for_turbines_tpu/tools/anchors.py`` (numpy
only, the same RNG draws): the JSON it writes is what
``tools/demo.py --anchors`` reads.

The reference ships this as an exported notebook
(reference: markdown/kmeansclustering.md:234-306,410-440): cluster the
dataset's (w, h) boxes with distance = 1 - IoU_wh, k-means++ seeding, output
9 centroids sorted by area and grouped 3-per-scale (largest anchors to the
stride-32 scale, matching config.TURBINE_ANCHORS ordering,
reference: code/config.py:53-57).

Usage:
    python -m yolo_for_turbines_tpu_torch.tools.anchors --labels data/labels \
        --k 9 --out anchors.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Tuple

import numpy as np


def load_wh_boxes(annotation_folder) -> np.ndarray:
    """Collect all (w, h) pairs from label txts ([class, cx, cy, w, h] rows)."""
    whs = []
    for path in sorted(Path(annotation_folder).glob("*.txt")):
        boxes = np.loadtxt(path)
        if boxes.ndim == 1:
            boxes = boxes[None, :]
        whs.append(boxes[:, 3:5])
    if not whs:
        raise ValueError(f"No label files in {annotation_folder}")
    return np.concatenate(whs)


def iou_wh(boxes: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """(N, 2) x (K, 2) -> (N, K) center-aligned wh IoU."""
    inter = np.minimum(boxes[:, None, 0], centroids[None, :, 0]) * np.minimum(
        boxes[:, None, 1], centroids[None, :, 1]
    )
    union = (
        boxes[:, 0] * boxes[:, 1]
    )[:, None] + (centroids[:, 0] * centroids[:, 1])[None, :] - inter
    return inter / union


def kmeans_pp_init(boxes: np.ndarray, k: int, rng: np.random.Generator):
    """k-means++ seeding under the 1-IoU distance
    (reference: markdown/kmeansclustering.md:285-306)."""
    centroids = [boxes[rng.integers(len(boxes))]]
    for _ in range(k - 1):
        d = 1.0 - iou_wh(boxes, np.asarray(centroids))
        d2 = d.min(axis=1) ** 2
        probs = d2 / d2.sum()
        centroids.append(boxes[rng.choice(len(boxes), p=probs)])
    return np.asarray(centroids)


def kmeans_anchors(
    boxes: np.ndarray,
    k: int = 9,
    iters: int = 300,
    seed: int = 0,
    init: str = "kmeans++",
) -> Tuple[np.ndarray, float]:
    """Cluster wh boxes; returns (centroids sorted by area desc, mean IoU)."""
    rng = np.random.default_rng(seed)
    if init == "kmeans++":
        centroids = kmeans_pp_init(boxes, k, rng)
    else:
        centroids = boxes[rng.choice(len(boxes), size=k, replace=False)]
    assign = None
    for _ in range(iters):
        d = 1.0 - iou_wh(boxes, centroids)
        new_assign = d.argmin(axis=1)
        if assign is not None and np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for j in range(k):
            members = boxes[assign == j]
            if len(members):
                centroids[j] = members.mean(axis=0)
    mean_iou = float(iou_wh(boxes, centroids).max(axis=1).mean())
    order = np.argsort(-(centroids[:, 0] * centroids[:, 1]), kind="stable")
    return centroids[order], mean_iou


def group_by_scale(centroids: np.ndarray) -> List[List[Tuple[float, float]]]:
    """9 area-sorted centroids -> 3 scales x 3 anchors, largest scale first
    (the stride-32 head predicts the biggest objects)."""
    k = len(centroids)
    per = k // 3
    return [
        [tuple(np.round(c, 4)) for c in centroids[i * per : (i + 1) * per]]
        for i in range(3)
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--labels", required=True, help="annotation folder")
    ap.add_argument("--k", type=int, default=9)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init", choices=("kmeans++", "random"), default="kmeans++")
    ap.add_argument("--out", default="anchors.json")
    args = ap.parse_args(argv)

    boxes = load_wh_boxes(args.labels)
    centroids, mean_iou = kmeans_anchors(
        boxes, args.k, args.iters, args.seed, args.init
    )
    anchors = group_by_scale(centroids)
    payload = {"anchors": anchors, "mean_iou": mean_iou, "num_boxes": len(boxes)}
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
