"""Traffic: the inputs of a cell, made from ``--seed`` and the parameters of
its mix (``traffic/<mix>.json``).

Every seed gets the same set of sizes, counts and boxes per image; the seed
changes the pixels, the boxes and the order. Device images are drawn on the
device in one call per batch; host images (what a user hands
``predict_image``) with numpy.

- :func:`device_images`: (N, S, S, 3) float32 in [0, 1] on the device, a
  smooth field (uniform noise at an eighth of the side, bilinear up) plus
  fine noise: pre-letterboxed photos with texture at every scale.
- :func:`host_images`: HWC uint8 frames of the mix's sizes, a textured
  background with a few filled rectangles.
- :func:`train_batch`: device images and their targets, a few seeded boxes
  per image encoded by :func:`assign_targets` (a copy of
  ``yolo_for_turbines_tpu_torch/tools/profile_serving.py::train_batch``,
  with 1 to 4 boxes).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return json.loads((HERE / f"{name}.json").read_text())


def device_images(gen: torch.Generator, n: int, side: int, device) -> torch.Tensor:
    low = torch.rand(n, 3, max(1, side // 8), max(1, side // 8), generator=gen, device=device)
    fine = torch.rand(n, 3, side, side, generator=gen, device=device)
    smooth = F.interpolate(low, size=(side, side), mode="bilinear", align_corners=False)
    img = (0.15 + 0.7 * smooth + 0.15 * (fine - 0.5)).clamp(0, 1)
    return img.permute(0, 2, 3, 1).contiguous()


def host_image(rng: np.random.Generator, w: int, h: int) -> np.ndarray:
    base = rng.uniform(60, 180)
    low = rng.normal(0, 18, (h // 8 + 1, w // 8 + 1, 3))
    bg = base + np.repeat(np.repeat(low, 8, 0), 8, 1)[:h, :w] \
        + rng.normal(0, 6, (h, w, 3))
    img = np.clip(bg, 0, 255).astype(np.uint8)
    short = min(w, h)
    for _ in range(3):
        bw = int(rng.uniform(0.12, 0.35) * short)
        bh = int(bw * rng.uniform(0.7, 1.4))
        x0, y0 = int(rng.uniform(0, w - bw)), int(rng.uniform(0, h - bh))
        img[y0 : y0 + bh, x0 : x0 + bw] = rng.uniform(120, 255, 3).astype(np.uint8)
    return img


def host_images(seed: int, sizes: Sequence[Sequence[int]], per_size: int):
    """(images, order): ``per_size`` frames of each (w, h), and a seeded
    order of their indices that the client cycles through."""
    rng = np.random.default_rng(seed)
    images = [host_image(rng, w, h) for w, h in sizes for _ in range(per_size)]
    return images, [int(i) for i in rng.permutation(len(images))]


def _iou_wh(wh, anchors):
    inter = np.minimum(wh[0], anchors[:, 0]) * np.minimum(wh[1], anchors[:, 1])
    return inter / (wh[0] * wh[1] + anchors[:, 0] * anchors[:, 1] - inter)


def assign_targets(boxes, anchors: np.ndarray, grid_sizes: Sequence[int],
                   ignore_iou: float = 0.5) -> List[np.ndarray]:
    """YOLOv3's target grids (3 per scale: (A, S, S, 6) [x, y, w, h, obj,
    class] in cell units) for normalised [cx, cy, w, h, class] boxes: each box
    takes the best free anchor of every scale in ranked order, once per scale;
    a free anchor above ``ignore_iou`` that is not taken is marked -1."""
    per_scale = len(anchors) // len(grid_sizes)
    grids = [np.zeros((per_scale, s, s, 6), np.float32) for s in grid_sizes]
    for x, y, w, h, cls in boxes:
        ious = _iou_wh(np.asarray([w, h], np.float64), anchors)
        has = [False] * len(grid_sizes)
        for a in np.argsort(-ious, kind="stable"):
            scale, k = int(a) // per_scale, int(a) % per_scale
            s = grid_sizes[scale]
            i, j = min(int(s * y), s - 1), min(int(s * x), s - 1)
            taken = grids[scale][k, i, j, 4]
            if not taken and not has[scale]:
                grids[scale][k, i, j] = (s * x - j, s * y - i, w * s, h * s, 1, int(cls))
                has[scale] = True
            elif not taken and ious[a] > ignore_iou:
                grids[scale][k, i, j, 4] = -1
    return grids


def train_batch(gen: torch.Generator, rng: np.random.Generator, mix: dict, cfg: dict,
                device):
    """(images, targets): one batch of the mix on ``device``."""
    b, side = mix["batch"], cfg["image_size"]
    anchors = np.asarray(cfg["anchors"], np.float64).reshape(-1, 2)
    grid_sizes = [side // s for s in cfg["strides"]]
    lo, hi = mix["boxes_per_image"]
    per_image = []
    for _ in range(b):
        boxes = [[*rng.uniform(*mix["box_center"], 2), *rng.uniform(*mix["box_size"], 2),
                  int(rng.integers(cfg["num_classes"]))]
                 for _ in range(int(rng.integers(lo, hi + 1)))]
        per_image.append(assign_targets(boxes, anchors, grid_sizes))
    targets = tuple(torch.from_numpy(np.stack([t[i] for t in per_image])).to(device)
                    for i in range(len(grid_sizes)))
    return device_images(gen, b, side, device), targets
