"""Single-image serving: one client calls ``Predictor.predict_image`` with a
host uint8 frame, waits for its boxes, and sends the next; the frames cycle
through the mix's sizes in a seeded order.

Checked, on requests of the window drawn from the seed (the same number of
each size): the letterboxed input the model was given against the
reference's letterbox (largest absolute difference), the raw heads against
the reference's float32 forward of its own letterbox (relative RMS error,
worst scale), and the boxes in the frame's own coordinates against the
reference's float32 decode, NMS and unletterbox of those same heads (the
share of boxes without a partner, ``reference/postprocess.py::mismatch``).
The control is the program's own int8 path (``Predictor.quantize``) for the
heads, and the reference's decode in bf16 in the program's place for the
boxes.
"""

from __future__ import annotations

import contextlib
import numpy as np
import torch

from .. import traffic, weights
from ..reference import postprocess as post
from . import RelRms, compute_dtype, folded_numpy, model_config, reference_heads, sample


class Driver:
    call_span = contextlib.nullcontext  # the harness puts a span here when tracing

    def __init__(self, cfg: dict, mix: dict, seed: int, device, variant: str = "program"):
        from yolo_for_turbines_tpu_torch.inference import Predictor

        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        side = cfg["image_size"]
        self.images, self.order = traffic.host_images(seed, mix["sizes"], mix["images_per_size"])
        # weights calibrated on frames of this traffic, letterboxed by the
        # reference: the first of each size
        per = mix["images_per_size"]
        calib = torch.stack([torch.from_numpy(post.letterbox(self.images[k * per], side))
                             for k in range(len(mix["sizes"]))]).to(self.device)
        self.plan, self.tree = weights.folded(cfg, 4 * int(seed), calib)
        self.pred = Predictor.from_folded(
            model_config(cfg), folded_numpy(self.plan, self.tree), device=self.device,
            anchors=cfg["anchors"], image_size=side, conf_threshold=cfg["conf_threshold"],
            nms_iou_threshold=cfg["nms_iou_threshold"], max_boxes=cfg["max_boxes"],
            compute_dtype=compute_dtype(cfg, self.device))
        self.variant = variant
        if variant == "control":
            self.pred.quantize(calib)
        elif variant != "program":
            raise ValueError(f"no variant {variant!r} for single-image serving")
        per = mix["images_per_size"]
        self.checked = sample(seed, mix["check_within"], mix["check_requests"],
                              key=lambda i: self._image(i) // per,
                              per_key=mix["check_requests"] // len(mix["sizes"]))
        self.captured, self.outputs = {}, {}
        self._capture = None
        # the heads of both paths (bf16 forward, or int8 once quantized)
        # come out of the predictor's ``_heads``
        self._heads = self.pred._heads
        self.pred._heads = self._keep
        self.attempted = 0

    def _image(self, i: int) -> int:
        return self.order[i % len(self.order)]

    def _keep(self, x):
        out = self._heads(x)
        if self._capture is not None:
            self.captured[self._capture] = (x.detach().clone(), [h.detach().clone() for h in out])
        return out

    def warm(self) -> None:
        per = self.mix["images_per_size"]
        for _ in range(self.mix["warm_iterations"]):
            for k in range(len(self.mix["sizes"])):
                self.pred.predict_image(self.images[k * per])

    def step(self, i: int) -> int:
        self._capture = i if i in self.checked else None
        with self.call_span():
            boxes = self.pred.predict_image(self.images[self._image(i)])
        if self._capture is not None:
            self.outputs[i] = boxes
        self._capture = None
        self.attempted += 1
        return 1

    def finish(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def spans(self):
        from ..trace import module_spans

        return module_spans([self.pred.model], lambda m, x: "model.forward")

    def call_name(self) -> str:
        return "predict_image"

    def release(self) -> None:
        self.pred = self._heads = None

    def _boxes(self, heads, hw, dtype=torch.float32):
        """The reference's decode, NMS and unletterbox of one image's heads."""
        side = self.cfg["image_size"]
        with torch.no_grad():
            rows = post.decode(heads, self.cfg["anchors"], self.cfg["num_classes"], dtype)
            cand, keep = post.nms(rows, self.cfg["conf_threshold"],
                                  self.cfg["nms_iou_threshold"], self.cfg["max_boxes"])
        return post.unletterbox(post.kept_rows(cand, keep)[0], hw, side)

    def check(self):
        heads = RelRms()
        worst_input = 0.0
        bad = total = 0
        side = self.cfg["image_size"]
        for i in self.checked:
            if i not in self.outputs:
                return {"input_max_abs": None, "heads_rel_rms": None, "boxes_unmatched": None}
            img = self.images[self._image(i)]
            lb = torch.from_numpy(post.letterbox(img, side))[None].to(self.device)
            x, got_heads = self.captured[i]
            worst_input = max(worst_input, float((x.float() - lb).abs().max()))
            want = reference_heads(self.plan, self.tree, lb, self.cfg["activation"])
            for s, (g, w) in enumerate(zip(got_heads, want)):
                heads.add(s, g.float(), w)
            if self.variant == "control":
                got = self._boxes(got_heads, img.shape[:2], torch.bfloat16)
            else:
                got = np.asarray(self.outputs[i], np.float64).reshape(-1, 6)
            b, t = post.mismatch([got], [self._boxes(got_heads, img.shape[:2])])
            bad, total = bad + b, total + t
        return {"input_max_abs": worst_input, "heads_rel_rms": heads.worst(),
                "boxes_unmatched": bad / max(total, 1), "boxes_compared": float(total)}
