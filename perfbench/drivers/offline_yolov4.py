"""Offline serving of YOLOv4: ``drivers/offline.py``'s closed loop of
``Predictor.predict_batch`` over a pool of device-resident, pre-letterboxed
batches, each ending when its ``(kept, mask)`` reach the host, with
YOLOv4's plan (the configuration's layer list), its weights
(``weights_yolov4.py``) and its reference (``reference/yolov4.py``).

Checked, as in ``offline``, on batches of the window drawn from the seed:
the raw heads of all scales against the reference's float32 forward
(relative RMS error, worst scale), and the kept boxes against the
reference's float32 decode (with each scale's ``scale_xy``) and NMS of
those same heads. The control is the reference's forward with every conv's
input and weight rounded through float8 e4m3 (``reference/model.py::
fp8_quant``) in the program's forward's place, for the heads, and the
reference's decode in bf16 in the program's place, for the boxes.

A program whose plan has no YOLOv4 entries refuses the layer list before
any weight is made.
"""

from __future__ import annotations

import torch

from .. import traffic, weights_yolov4
from ..reference import model as ref
from ..reference import postprocess as post
from ..reference import yolov4 as v4
from . import RelRms, compute_dtype, model_config, offline, sample, seeded

BLOCK = 16  # images per reference forward at 608px


def numpy_tree(node):
    """The reference's folded tree in the layout ``Predictor.from_folded``
    takes (HWIO numpy float32): its structure is the program's, one entry
    per item of the layer list."""
    if isinstance(node, dict) and "w" in node:
        return {"w": node["w"].permute(2, 3, 1, 0).contiguous().cpu().numpy(),
                "b": node["b"].cpu().numpy()}
    if isinstance(node, dict):
        return {k: numpy_tree(v) for k, v in node.items()}
    return [numpy_tree(v) for v in node]


class Driver(offline.Driver):
    def __init__(self, cfg: dict, mix: dict, seed: int, device, variant: str = "program"):
        from yolo_for_turbines_tpu_torch.inference import Predictor
        from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan

        if variant not in ("program", "control"):
            raise ValueError(f"no variant {variant!r} for offline serving")
        model_cfg = model_config(cfg)
        build_plan(model_cfg)
        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        side, b = cfg["image_size"], mix["batch"]
        calib = traffic.device_images(seeded(seed, 1, self.device), mix["calibration_images"],
                                      side, self.device)
        self.plan, self.tree = weights_yolov4.folded(cfg, 4 * int(seed), calib)
        self.scale_xy = v4.scale_xy(self.plan)
        gen = seeded(seed, 2, self.device)
        self.pool = [traffic.device_images(gen, b, side, self.device) for _ in range(mix["pool"])]
        self.pred = Predictor.from_folded(
            model_cfg, numpy_tree(self.tree), device=self.device, anchors=cfg["anchors"],
            image_size=side, conf_threshold=cfg["conf_threshold"],
            nms_iou_threshold=cfg["nms_iou_threshold"], max_boxes=cfg["max_boxes"],
            compute_dtype=compute_dtype(cfg, self.device))
        self.variant = variant
        self.checked = sample(seed, mix["check_within"], mix["check_batches"],
                              key=lambda i: i % mix["pool"])
        self.captured = {}
        self.outputs = {}
        self._capture = None
        self._heads = self.pred._heads if variant == "program" else self._fp8_heads
        self.pred._heads = self._keep
        self.attempted = 0

    def _fp8_heads(self, x):
        with ref.exact_f32():
            return v4.folded_forward(self.plan, self.tree, x, self.cfg["activation"],
                                     quant=ref.fp8_quant)

    def _reference_heads(self, x):
        outs = []
        with ref.exact_f32(), torch.no_grad():
            for i in range(0, x.shape[0], BLOCK):
                outs.append(v4.folded_forward(self.plan, self.tree, x[i : i + BLOCK],
                                              self.cfg["activation"]))
        return [torch.cat(parts) for parts in zip(*outs)]

    def _boxes(self, heads, dtype=torch.float32):
        """The reference's decode and NMS of ``heads``: each image's kept rows."""
        with torch.no_grad():
            rows = v4.decode(heads, self.cfg["anchors"], self.cfg["num_classes"],
                             self.scale_xy, dtype)
            cand, keep = post.nms(rows, self.cfg["conf_threshold"],
                                  self.cfg["nms_iou_threshold"], self.cfg["max_boxes"])
        return post.kept_rows(cand, keep)

    def check(self):
        heads = RelRms()
        bad = total = 0
        for i in self.checked:
            if i not in self.outputs:
                return {"heads_rel_rms": None, "boxes_unmatched": None}
            want = self._reference_heads(self.pool[i % len(self.pool)])
            for s, (g, w) in enumerate(zip(self.captured[i], want)):
                heads.add(s, g.float(), w)
            if self.variant == "control":
                got = self._boxes(self.captured[i], torch.bfloat16)
            else:
                got = post.kept_rows(*self.outputs[i])
            b, t = post.mismatch(got, self._boxes(self.captured[i]))
            bad, total = bad + b, total + t
        return {"heads_rel_rms": heads.worst(), "boxes_unmatched": bad / max(total, 1),
                "boxes_compared": float(total)}
