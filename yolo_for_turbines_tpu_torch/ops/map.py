"""mAP@IoU on the host (numpy) and on the device (torch), counterpart of
``yolo_for_turbines_tpu/ops/map.py``.

Semantics of every function (reference: code/utils.py:193-274): per class,
detections sorted by score, descending, greedily match their image's
best-IoU ground truth (IoU strictly above the threshold); a detection whose
best ground truth is already matched is a false positive (it does not fall
back to the runner-up). Cumulative TP / FP give precision and recall with a
prepended (recall 0, precision 1) point; AP is the trapezoid; mAP the mean
over the classes that have ground truth (0.0 when none has).

``calc_map`` / ``calc_map_range`` are the host versions, copied. The device
versions replace the JAX ``lax.scan`` over the score-sorted slots, vmapped
over classes, by a Python loop over the slots in which each step updates
every class at once (a ``(C, I, G)`` tensor), so a launch count grows with
the slots, not with classes x slots. They sort with ``argsort(-scores,
stable=True)`` as the JAX code does, take the first maximum in each argmax,
and write ``matched`` with a scatter along the ground-truth axis.
"""

from __future__ import annotations

import numpy as np
import torch

from .iou import calc_iou


def _iou_center(box1, boxes2):
    """IoU of one cxcywh box against (M, 4) cxcywh boxes (+1e-6, parity)."""
    b1 = np.asarray(box1, dtype=np.float64)
    b2 = np.asarray(boxes2, dtype=np.float64)
    b1_xy = b1[:2] - b1[2:4] / 2
    b2_xy = b2[:, :2] - b2[:, 2:4] / 2
    xA = np.maximum(b1_xy[0], b2_xy[:, 0])
    yA = np.maximum(b1_xy[1], b2_xy[:, 1])
    xB = np.minimum(b1_xy[0] + b1[2], b2_xy[:, 0] + b2[:, 2])
    yB = np.minimum(b1_xy[1] + b1[3], b2_xy[:, 1] + b2[:, 3])
    inter = np.clip(xB - xA, 0, None) * np.clip(yB - yA, 0, None)
    union = b1[2] * b1[3] + b2[:, 2] * b2[:, 3] - inter
    return inter / (union + 1e-6)


def _iou_corner(box1, boxes2):
    """IoU with top-left xywh boxes (the reference's 'corner' branch)."""
    b1 = np.asarray(box1, dtype=np.float64)
    b2 = np.asarray(boxes2, dtype=np.float64)
    xA = np.maximum(b1[0], b2[:, 0])
    yA = np.maximum(b1[1], b2[:, 1])
    xB = np.minimum(b1[0] + b1[2], b2[:, 0] + b2[:, 2])
    yB = np.minimum(b1[1] + b1[3], b2[:, 1] + b2[:, 3])
    inter = np.clip(xB - xA, 0, None) * np.clip(yB - yA, 0, None)
    union = b1[2] * b1[3] + b2[:, 2] * b2[:, 3] - inter
    return inter / (union + 1e-6)


def calc_map(
    pred_boxes,
    true_boxes,
    iou_threshold: float = 0.5,
    box_format: str = "center",
    num_classes: int = 20,
) -> float:
    """Mean average precision at one IoU threshold, in numpy on the host.

    Args:
        pred_boxes: rows [image_id, cx, cy, w, h, score, class].
        true_boxes: rows [image_id, cx, cy, w, h, score, class].
        iou_threshold: match threshold (strict >).
        box_format: "center" or "corner" (top-left xywh).
        num_classes: classes to average over (classes without GT skipped).
    """
    preds = np.asarray(pred_boxes, dtype=np.float64).reshape(-1, 7)
    truths = np.asarray(true_boxes, dtype=np.float64).reshape(-1, 7)
    iou_fn = _iou_center if box_format == "center" else _iou_corner

    average_precisions = []
    for c in range(num_classes):
        det = preds[preds[:, 6] == c]
        gts = truths[truths[:, 6] == c]
        total_true = len(gts)
        if total_true == 0:
            continue

        # per-image GT pools and matched flags
        gt_by_image = {}
        for row in gts:
            gt_by_image.setdefault(row[0], []).append(row[1:5])
        gt_by_image = {k: np.asarray(v) for k, v in gt_by_image.items()}
        matched = {k: np.zeros(len(v), dtype=bool) for k, v in gt_by_image.items()}

        # descending score, stable (parity with list.sort)
        order = np.argsort(-det[:, 5], kind="stable")
        det = det[order]

        tp = np.zeros(len(det))
        fp = np.zeros(len(det))
        for i, d in enumerate(det):
            img = d[0]
            img_gts = gt_by_image.get(img)
            best_iou, best_idx = 0.0, 0
            if img_gts is not None and len(img_gts):
                ious = iou_fn(d[1:5], img_gts)
                best_idx = int(np.argmax(ious))
                best_iou = float(ious[best_idx])
            if best_iou > iou_threshold:
                if not matched[img][best_idx]:
                    tp[i] = 1
                    matched[img][best_idx] = True
                else:
                    fp[i] = 1
            else:
                fp[i] = 1

        cum_tp = np.cumsum(tp)
        cum_fp = np.cumsum(fp)
        with np.errstate(invalid="ignore", divide="ignore"):
            precisions = cum_tp / (cum_tp + cum_fp)
        recalls = cum_tp / total_true
        precisions = np.concatenate(([1.0], precisions))
        recalls = np.concatenate(([0.0], recalls))
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        average_precisions.append(trapezoid(precisions, recalls))

    if not average_precisions:
        return 0.0
    return float(sum(average_precisions) / len(average_precisions))


def _coco_thresholds():
    return [0.5 + 0.05 * i for i in range(10)]


def calc_map_range(
    pred_boxes,
    true_boxes,
    iou_thresholds=None,
    box_format: str = "center",
    num_classes: int = 20,
) -> dict:
    """COCO-style mAP over a threshold range:
    {"mAP@0.5": ..., "mAP@0.75": ..., "mAP@[.5:.95]": mean}."""
    if iou_thresholds is None:
        iou_thresholds = _coco_thresholds()
    aps = {
        t: calc_map(pred_boxes, true_boxes, t, box_format, num_classes)
        for t in iou_thresholds
    }
    out = {f"mAP@{t:g}": v for t, v in aps.items()}
    out["mAP@[.5:.95]"] = float(np.mean(list(aps.values())))
    return out


def _mean_ap(aps: torch.Tensor, has_gt: torch.Tensor) -> torch.Tensor:
    """Mean over the classes with ground truth; 0 when none has."""
    n = has_gt.sum()
    mean = torch.where(has_gt, aps, torch.zeros_like(aps)).sum() / n.clamp(min=1)
    return torch.where(n > 0, mean, torch.zeros_like(mean))


def _trapezoid_ap(cum_tp, precisions, total_true) -> torch.Tensor:
    """(C, N) cumulative TP and precision -> (C,) AP with the prepended
    (recall 0, precision 1) point."""
    recalls = cum_tp / total_true.to(cum_tp.dtype).clamp(min=1e-16)[:, None]
    c = cum_tp.shape[0]
    precisions = torch.cat([torch.ones(c, 1, device=cum_tp.device), precisions], dim=1)
    recalls = torch.cat([torch.zeros(c, 1, device=cum_tp.device), recalls], dim=1)
    return torch.sum(
        (recalls[:, 1:] - recalls[:, :-1]) * (precisions[:, 1:] + precisions[:, :-1]) / 2,
        dim=1,
    )


def _greedy_match(ious_at, det_ok, num_gt: int, iou_threshold: float) -> torch.Tensor:
    """The greedy match, one score-ranked slot per step for every class (and
    image) at once.

    ious_at(n): (C, ..., G) IoU of slot n against each ground truth, 0 where
    the pair may not match; det_ok: (C, N, ...) slot n is a detection of the
    class. Returns the (C, N, ...) true positives."""
    tps = torch.empty(det_ok.shape, dtype=torch.bool, device=det_ok.device)
    matched = torch.zeros(det_ok.shape[:1] + det_ok.shape[2:] + (num_gt,), dtype=torch.bool,
                          device=det_ok.device)
    for n in range(det_ok.shape[1]):
        ious_n = ious_at(n)
        best = torch.argmax(ious_n, dim=-1, keepdim=True)  # first maximum
        best_iou = torch.gather(ious_n, -1, best)[..., 0]
        already = torch.gather(matched, -1, best)
        is_tp = det_ok[:, n] & (best_iou > iou_threshold) & ~already[..., 0]
        matched.scatter_(-1, best, already | is_tp[..., None])
        tps[:, n] = is_tp
    return tps


class _Bucketed:
    """What ``calc_map_device_batched`` computes once for any threshold:
    the per-image score sort, the one (I, K, G) IoU tensor all classes
    share, the per-class masks and the global score order."""

    def __init__(self, preds, pred_valid, gts, gt_valid, num_classes: int):
        preds = torch.as_tensor(preds, dtype=torch.float32)
        dev = preds.device
        gts = torch.as_tensor(gts, dtype=torch.float32, device=dev)
        pred_valid = torch.as_tensor(pred_valid, device=dev).to(torch.bool)
        gt_valid = torch.as_tensor(gt_valid, device=dev).to(torch.bool)

        # per-image stable descending sort, shared by every class; invalid
        # slots sink
        scores = torch.where(pred_valid, preds[:, :, 4],
                             torch.full_like(preds[:, :, 4], float("-inf")))
        order = torch.argsort(-scores, dim=1, stable=True)
        preds_s = torch.gather(preds, 1, order[..., None].expand(-1, -1, preds.shape[-1]))
        valid_s = torch.gather(pred_valid, 1, order)
        scores_s = torch.gather(scores, 1, order)

        # (K, I, G): one slot per step of the greedy match
        iou = calc_iou(preds_s[:, :, None, 0:4], gts[:, None, :, 0:4], "center")
        self.iou_t = iou.permute(1, 0, 2).contiguous()

        classes = torch.arange(num_classes, dtype=torch.float32, device=dev)[:, None, None]
        self.det_ok = valid_s[None] & (preds_s[None, :, :, 5] == classes)  # (C, I, K)
        self.gt_ok = gt_valid[None] & (gts[None, :, :, 5] == classes)  # (C, I, G)
        self.total_true = self.gt_ok.sum(dim=(1, 2))
        # global stable score order (class-independent), for the cumsums
        self.flat_order = torch.argsort(-scores_s.reshape(-1), stable=True)

    def map_at(self, iou_threshold: float) -> torch.Tensor:
        c = self.det_ok.shape[0]
        # the (C, I, G) masked IoU of one slot per step: never (C, K, I, G)
        tps = _greedy_match(lambda n: torch.where(self.gt_ok, self.iou_t[n], 0.0),
                            self.det_ok.transpose(1, 2), self.gt_ok.shape[-1], iou_threshold)
        tp = tps.transpose(1, 2).float()  # (C, I, K)
        fp = torch.where(self.det_ok, 1.0 - tp, 0.0)

        cum_tp = torch.cumsum(tp.reshape(c, -1)[:, self.flat_order], dim=1)
        cum_fp = torch.cumsum(fp.reshape(c, -1)[:, self.flat_order], dim=1)
        # the cumsums run over ALL I*K slots, so slots before a class's first
        # detection have cum_tp + cum_fp == 0: their precision is the
        # prepended point's 1.0, not 0, else a class whose top detection is
        # a TP loses 1/(2*total_true) of AP (a ground-truth replay would
        # score below 1.0)
        seen = cum_tp + cum_fp
        precisions = torch.where(seen > 0, cum_tp / seen.clamp(min=1e-16), 1.0)
        aps = _trapezoid_ap(cum_tp, precisions, self.total_true)
        return _mean_ap(aps, self.total_true > 0)


@torch.no_grad()
def calc_map_device_batched(
    preds,
    pred_valid,
    gts,
    gt_valid,
    iou_threshold: float = 0.5,
    num_classes: int = 20,
) -> torch.Tensor:
    """Device mAP over per-image padded slots, memory O(C * I * G) per step.

    A detection competes only for ground truth of its own image, and whether
    it wins depends only on higher-scored detections of that image, so the
    global greedy decomposes into per-image greedies over the K slots; only
    the TP / FP cumsums need the global score order, which is the same for
    every class. Equal scores keep image-major order, as in the reference.

    Args:
        preds: (I, K, 6) [cx, cy, w, h, score, class] per-image NMS
            survivors, padded.
        pred_valid: (I, K) bool.
        gts: (I, G, 6) same layout (score column unused), padded.
        gt_valid: (I, G) bool.

    Returns:
        0-dim float32 tensor on the device of ``preds``.
    """
    return _Bucketed(preds, pred_valid, gts, gt_valid, num_classes).map_at(iou_threshold)


@torch.no_grad()
def calc_map_device_range(
    preds,
    pred_valid,
    gts,
    gt_valid,
    iou_thresholds=None,
    num_classes: int = 20,
) -> dict:
    """Device COCO-style mAP over a threshold range (the device twin of
    ``calc_map_range``): the sort, the IoU tensor and the masks are computed
    once for all thresholds. Returns {"mAP@0.5": ..., "mAP@[.5:.95]": mean}
    of floats."""
    if iou_thresholds is None:
        iou_thresholds = _coco_thresholds()
    prep = _Bucketed(preds, pred_valid, gts, gt_valid, num_classes)
    aps = torch.stack([prep.map_at(float(t)) for t in iou_thresholds]).cpu().numpy()
    out = {f"mAP@{t:g}": float(v) for t, v in zip(iou_thresholds, aps)}
    out["mAP@[.5:.95]"] = float(aps.mean())
    return out


@torch.no_grad()
def calc_map_device(
    pred_boxes,
    pred_valid,
    true_boxes,
    true_valid,
    iou_threshold: float = 0.5,
    num_classes: int = 20,
) -> torch.Tensor:
    """Device mAP over flat padded rows, with the full (N, M) IoU matrix:
    for tests and small sets (``calc_map_device_batched`` is the scalable
    one).

    Args:
        pred_boxes: (N, 7) [image_id, cx, cy, w, h, score, class], padded.
        pred_valid: (N,) bool.
        true_boxes: (M, 7) same layout (score column unused), padded.
        true_valid: (M,) bool.
    """
    preds = torch.as_tensor(pred_boxes, dtype=torch.float32)
    dev = preds.device
    gts = torch.as_tensor(true_boxes, dtype=torch.float32, device=dev)
    pred_valid = torch.as_tensor(pred_valid, device=dev).to(torch.bool)
    true_valid = torch.as_tensor(true_valid, device=dev).to(torch.bool)

    # IoU of every detection against every GT, gated by same image and class
    iou_all = calc_iou(preds[:, None, 1:5], gts[None, :, 1:5], "center")
    pair = (preds[:, 0:1] == gts[None, :, 0]) & (preds[:, 6:7] == gts[None, :, 6])

    classes = torch.arange(num_classes, dtype=torch.float32, device=dev)[:, None]
    det_ok = pred_valid[None] & (preds[None, :, 6] == classes)  # (C, N)
    gt_ok = true_valid[None] & (gts[None, :, 6] == classes)  # (C, M)
    total_true = gt_ok.sum(dim=1)

    # a per-class order: this class's detections by descending score first
    key = torch.where(det_ok, -preds[None, :, 5], float("inf"))
    order = torch.argsort(key, dim=1, stable=True)  # (C, N)
    det_ok_sorted = torch.gather(det_ok, 1, order)
    pair_ok = pair[order] & gt_ok[:, None, :]  # (C, N, M)
    iou_sorted = torch.where(pair_ok, iou_all[order], 0.0)

    tp = _greedy_match(lambda n: iou_sorted[:, n], det_ok_sorted, gts.shape[0],
                       iou_threshold).float()
    fp = torch.where(det_ok_sorted, 1.0 - tp, 0.0)
    cum_tp = torch.cumsum(tp, dim=1)
    cum_fp = torch.cumsum(fp, dim=1)
    precisions = cum_tp / (cum_tp + cum_fp).clamp(min=1e-16)
    # padded rows sort last and leave both cumsums unchanged: zero-width
    # trapezoids, no masking needed
    aps = _trapezoid_ap(cum_tp, precisions, total_true)
    return _mean_ap(aps, total_true > 0)
