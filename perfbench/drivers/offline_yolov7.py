"""Offline serving of YOLOv7: ``drivers/offline_yolov4.py``'s closed loop of
``Predictor.predict_batch`` over a pool of device-resident, pre-letterboxed
batches, each ending when its ``(kept, mask)`` reach the host, and its
checks, with YOLOv7's plan (the configuration's layer list), its weights
(``weights_yolov7.py``) and its reference (``reference/yolov7.py``).

Checked on batches of the window drawn from the seed: the raw heads of all
scales against the reference's float32 forward (relative RMS error, worst
scale), and the kept boxes against the reference's float32 decode (each
scale's ``scale_xy`` and squared-size decode) and NMS of those same heads.
The control is the reference's forward with every conv's input and weight
rounded through float8 e4m3 (``reference/model.py::fp8_quant``) in the
program's forward's place, for the heads, and the reference's decode in
bf16 in the program's place, for the boxes.

A program whose plan has no YOLOv7 entries refuses the layer list before
any weight is made.
"""

from __future__ import annotations

import torch

from .. import traffic, weights_yolov7
from ..reference import model as ref
from ..reference import postprocess as post
from ..reference import yolov7 as v7
from . import compute_dtype, model_config, offline_yolov4, sample, seeded

BLOCK = 16  # images per reference forward at 640px


class Driver(offline_yolov4.Driver):
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
        self.plan, self.tree = weights_yolov7.folded(cfg, 4 * int(seed), calib)
        self.scale_xy = v7.scale_xy(self.plan)
        gen = seeded(seed, 2, self.device)
        self.pool = [traffic.device_images(gen, b, side, self.device) for _ in range(mix["pool"])]
        self.pred = Predictor.from_folded(
            model_cfg, offline_yolov4.numpy_tree(self.tree), device=self.device,
            anchors=cfg["anchors"], image_size=side, conf_threshold=cfg["conf_threshold"],
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
            return v7.folded_forward(self.plan, self.tree, x, quant=ref.fp8_quant)

    def _reference_heads(self, x):
        outs = []
        with ref.exact_f32(), torch.no_grad():
            for i in range(0, x.shape[0], BLOCK):
                outs.append(v7.folded_forward(self.plan, self.tree, x[i : i + BLOCK]))
        return [torch.cat(parts) for parts in zip(*outs)]

    def _boxes(self, heads, dtype=torch.float32):
        """The reference's decode and NMS of ``heads``: each image's kept rows."""
        with torch.no_grad():
            rows = v7.decode(heads, self.cfg["anchors"], self.cfg["num_classes"],
                             self.scale_xy, dtype)
            cand, keep = post.nms(rows, self.cfg["conf_threshold"],
                                  self.cfg["nms_iou_threshold"], self.cfg["max_boxes"])
        return post.kept_rows(cand, keep)
