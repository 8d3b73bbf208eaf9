"""Offline serving: ``Predictor.predict_batch`` in a closed loop over a pool
of device-resident, pre-letterboxed batches; each batch ends when its
``(kept, mask)`` reach the host.

Checked, on batches of the window drawn from the seed: the raw heads of all
scales against the reference's float32 forward (relative RMS error, worst
scale), and the kept boxes against the reference's float32 decode and NMS
of those same heads (the share of boxes without a partner,
``reference/postprocess.py::mismatch``). The control is the program's own
int8 path (``Predictor.quantize``) for the heads, and the reference's decode
in bf16 in the program's place for the boxes.
"""

from __future__ import annotations

import contextlib
import torch

from .. import traffic, weights
from ..reference import postprocess as post
from . import RelRms, compute_dtype, folded_numpy, model_config, reference_heads, sample, seeded


class Driver:
    call_span = contextlib.nullcontext  # the harness puts a span here when tracing

    def __init__(self, cfg: dict, mix: dict, seed: int, device, variant: str = "program"):
        from yolo_for_turbines_tpu_torch.inference import Predictor

        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        side, b = cfg["image_size"], mix["batch"]
        calib = traffic.device_images(seeded(seed, 1, self.device), mix["calibration_images"],
                                      side, self.device)
        self.plan, self.tree = weights.folded(cfg, 4 * int(seed), calib)
        gen = seeded(seed, 2, self.device)
        self.pool = [traffic.device_images(gen, b, side, self.device) for _ in range(mix["pool"])]
        self.pred = Predictor.from_folded(
            model_config(cfg), folded_numpy(self.plan, self.tree), device=self.device,
            anchors=cfg["anchors"], image_size=side, conf_threshold=cfg["conf_threshold"],
            nms_iou_threshold=cfg["nms_iou_threshold"], max_boxes=cfg["max_boxes"],
            compute_dtype=compute_dtype(cfg, self.device))
        self.variant = variant
        if variant == "control":
            self.pred.quantize(calib)
        elif variant != "program":
            raise ValueError(f"no variant {variant!r} for offline serving")
        self.checked = sample(seed, mix["check_within"], mix["check_batches"],
                              key=lambda i: i % mix["pool"])
        self.captured = {}
        self.outputs = {}
        self._capture = None
        # the heads of both paths (bf16 forward, or int8 once quantized)
        # come out of the predictor's ``_heads``
        self._heads = self.pred._heads
        self.pred._heads = self._keep
        self.attempted = 0

    def _keep(self, x):
        out = self._heads(x)
        if self._capture is not None:
            self.captured[self._capture] = [h.detach().clone() for h in out]
        return out

    def warm(self) -> None:
        for _ in range(self.mix["warm_iterations"]):
            for x in self.pool:
                kept, mask = self.pred.predict_batch(x)
                kept.cpu(), mask.cpu()

    def step(self, i: int) -> int:
        x = self.pool[i % len(self.pool)]
        self._capture = i if i in self.checked else None
        with self.call_span():
            kept, mask = self.pred.predict_batch(x)
        kept, mask = kept.cpu(), mask.cpu()
        if self._capture is not None:
            self.outputs[i] = (kept, mask)
        self._capture = None
        self.attempted += x.shape[0]
        return x.shape[0]

    def finish(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def spans(self):
        from ..trace import module_spans
        from yolo_for_turbines_tpu_torch.models.yolov3 import ResidualStage

        # the stacks of blocks with shortcuts (not a head's conv pair)
        stages = [m for m in self.pred.model.modules()
                  if isinstance(m, ResidualStage) and m.entry.use_residual]
        return (module_spans([self.pred.model], lambda m, x: "model.forward")
                + module_spans(stages, lambda m, x: "resstage.{}x{}x{}".format(
                    x.shape[1], x.shape[2], x.shape[3])))

    def call_name(self) -> str:
        return "predict_batch"

    def release(self) -> None:
        self.pred = self._heads = None

    def _boxes(self, heads, dtype=torch.float32):
        """The reference's decode and NMS of ``heads``: each image's kept rows."""
        with torch.no_grad():
            rows = post.decode(heads, self.cfg["anchors"], self.cfg["num_classes"], dtype)
            cand, keep = post.nms(rows, self.cfg["conf_threshold"],
                                  self.cfg["nms_iou_threshold"], self.cfg["max_boxes"])
        return post.kept_rows(cand, keep)

    def check(self):
        heads = RelRms()
        bad = total = 0
        for i in self.checked:
            if i not in self.outputs:
                return {"heads_rel_rms": None, "boxes_unmatched": None}
            x = self.pool[i % len(self.pool)]
            want = reference_heads(self.plan, self.tree, x, self.cfg["activation"])
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
