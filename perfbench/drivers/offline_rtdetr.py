"""Offline serving of RT-DETR: ``drivers/offline_yolov4.py``'s closed loop of
``Predictor.predict_batch`` over a pool of device-resident, pre-letterboxed
batches, each ending when its ``(kept, mask)`` reach the host, with
RT-DETR's plan (the configuration's layer list), its weights
(``weights_rtdetr.py``: the unfused tree, which the program loads into its
trainable model and folds itself) and its reference
(``reference/rtdetr.py``, on the reference's own fold of the same tree).

Checked on batches of the window drawn from the seed, whose forward
outputs (logits, boxes, memory, selected tokens) are kept from the timed
path:

- ``memory_rel_rms``: the program's memory against the reference's
  float32 forward (relative RMS error, worst level);
- ``select_missed``: the share of the reference's selected tokens that the
  program did not select (an invalid token, whose prior lies off the
  image, counts as any other invalid one: their targets and references are
  the same);
- ``decoder_rel_rms``: the program's final logits and boxes against the
  reference's decoder run from the program's selection (the reference's
  memory and selection head, teacher-forced), worst of the two;
- ``boxes_unmatched``: the kept rows against the reference's float32
  postprocess of the program's logits and boxes.

The control is the reference's forward with every conv's and every linear
layer's input and weight rounded through float8 e4m3
(``reference/model.py::fp8_quant``) in the program's forward's place, and
the reference's postprocess in bf16 in the program's place for the boxes.
Two faults planted in the program (``FAULTS``) read the checks that float8
moves least: ``mean_score`` ranks the encoder's tokens by their mean class
score instead of their best (``select_missed``), ``refs_transposed``
samples around each box's (y, x) for its (x, y) (``decoder_rel_rms``).

A program whose plan has no RT-DETR entries refuses the layer list before
any weight is made.
"""

from __future__ import annotations

import torch

from .. import traffic, weights_rtdetr
from ..reference import model as ref
from ..reference import postprocess as post
from ..reference import rtdetr as rt
from . import RelRms, compute_dtype, model_config, offline, sample, seeded

BLOCK = 16  # images per reference forward at 640px
ENTRIES = {"backbone": 0, "encoder": 1, "decoder": 2}


def _insert(tree, path, leaf) -> None:
    """``leaf`` at ``path`` of a nested dict / list tree (the ints of a list
    in order)."""
    for depth, key in enumerate(path):
        new = leaf if depth == len(path) - 1 else [] if isinstance(path[depth + 1], int) else {}
        if isinstance(tree, list):
            if key == len(tree):
                tree.append(new)
        else:
            tree.setdefault(key, new)
        tree = tree[key]


def program_trees(tree: dict):
    """The unfused tree as the program's trainable ``(params, stats)`` trees
    (``models/convert.py::load_trainable``): one entry per item of the
    layer list, each leaf at its module's path below the entry, conv
    weights HWIO, a conv's BN as ``scale`` / ``bias`` and ``mean`` /
    ``var`` (RepVGG's 1x1 branch suffixed ``1x1``), linear and norm leaves
    ``w`` / ``b`` with no statistics."""
    params, stats = [{} for _ in ENTRIES], [{} for _ in ENTRIES]

    def hwio(w):
        return w.permute(2, 3, 1, 0).contiguous().cpu().numpy()

    for name, node in tree.items():
        top, *rest = name.split(".")
        path = tuple(int(k) if k.isdigit() else k for k in rest)
        if "gamma" in node:
            p = {"w": hwio(node["w"]), "scale": node["gamma"], "bias": node["beta"]}
            s = {"mean": node["mean"], "var": node["var"]}
            if "w1x1" in node:
                p.update(w1x1=hwio(node["w1x1"]), scale1x1=node["gamma1x1"],
                         bias1x1=node["beta1x1"])
                s.update(mean1x1=node["mean1x1"], var1x1=node["var1x1"])
            p = {k: v if k.startswith("w") else v.cpu().numpy() for k, v in p.items()}
            s = {k: v.cpu().numpy() for k, v in s.items()}
        else:
            p, s = {k: v.cpu().numpy() for k, v in node.items()}, None
        _insert(params[ENTRIES[top]], path, p)
        _insert(stats[ENTRIES[top]], path, s)
    return params, stats


class MeanScore(torch.nn.Module):
    """A score head whose every class reads the mean of the head's class
    scores: the top-k then ranks tokens by that mean."""

    def __init__(self, head):
        super().__init__()
        self.head = head

    def forward(self, x):
        s = self.head(x)
        return s.mean(-1, keepdim=True).expand_as(s)


class TransposedRefs(torch.nn.Module):
    """A deformable cross-attention that samples around each box's (cy, cx,
    h, w) for its (cx, cy, w, h): the grid's row read for its column."""

    def __init__(self, attn):
        super().__init__()
        self.attn = attn

    def forward(self, query, ref, memory, shapes):
        return self.attn(query, ref[..., [1, 0, 3, 2]], memory, shapes)


def plant(model, fault: str) -> None:
    """``fault`` (one of ``FAULTS``) planted in ``model``'s RT-DETR decoder."""
    from yolo_for_turbines_tpu_torch.models.rtdetr import DETRDecoder

    for dec in (m for m in model.modules() if isinstance(m, DETRDecoder)):
        if fault == "mean_score":
            dec.enc_score_head = MeanScore(dec.enc_score_head)
        else:
            for layer in dec.decoder.layers:
                layer.cross_attn = TransposedRefs(layer.cross_attn)


FAULTS = ("mean_score", "refs_transposed")


def missed(got_idx: torch.Tensor, want_idx: torch.Tensor, valid: torch.Tensor) -> int:
    """Tokens of ``want_idx`` (B, Q) that ``got_idx`` lacks, per image, an
    invalid token standing for any other."""
    n = 0
    for g, w in zip(got_idx.tolist(), want_idx.tolist()):
        gv = {t for t in g if valid[t]}
        wv = {t for t in w if valid[t]}
        n += len(wv - gv) + max(0, (len(w) - len(wv)) - (len(g) - len(gv)))
    return n


class Driver(offline.Driver):
    def __init__(self, cfg: dict, mix: dict, seed: int, device, variant: str = "program"):
        from yolo_for_turbines_tpu_torch.inference import Predictor
        from yolo_for_turbines_tpu_torch.models.convert import trainable_from_numpy
        from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan

        if variant not in ("program", "control", *FAULTS):
            raise ValueError(f"no variant {variant!r} for offline serving")
        model_cfg = model_config(cfg)
        plan = build_plan(model_cfg)
        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        side, b = cfg["image_size"], mix["batch"]
        calib = traffic.device_images(seeded(seed, 1, self.device), mix["calibration_images"],
                                      side, self.device)
        unfused = weights_rtdetr.unfused(cfg, 4 * int(seed), calib)
        self.tree = rt.reparameterise(cfg, unfused)
        params, stats = program_trees(unfused)
        folded = trainable_from_numpy(plan, params, stats, model_cfg, device="cpu").eval().fold()
        del unfused, params, stats
        gen = seeded(seed, 2, self.device)
        self.pool = [traffic.device_images(gen, b, side, self.device) for _ in range(mix["pool"])]
        self.pred = Predictor.from_folded(
            model_cfg, folded, device=self.device, image_size=side,
            conf_threshold=cfg["conf_threshold"], compute_dtype=compute_dtype(cfg, self.device))
        self.variant = variant
        if variant in FAULTS:
            plant(self.pred.model, variant)
        self.checked = sample(seed, mix["check_within"], mix["check_batches"],
                              key=lambda i: i % mix["pool"])
        self.captured = {}
        self.outputs = {}
        self._capture = None
        self._heads = self._fp8_heads if variant == "control" else self.pred._heads
        self.pred._heads = self._keep
        self.attempted = 0

    def _fp8_heads(self, x):
        outs = []
        with ref.exact_f32():
            for i in range(0, x.shape[0], BLOCK):
                memory, idx, logits, boxes = rt.folded_forward(self.cfg, self.tree,
                                                               x[i : i + BLOCK],
                                                               quant=ref.fp8_quant)
                outs.append((logits, boxes, memory, idx))
        return [torch.cat(parts) for parts in zip(*outs)]

    def check(self):
        memory, decoder = RelRms(), RelRms()
        lost = chosen = bad = total = 0
        q = rt.sizes(self.cfg)["queries"]
        for i in self.checked:
            if i not in self.outputs:
                return {"memory_rel_rms": None, "select_missed": None, "decoder_rel_rms": None,
                        "boxes_unmatched": None}
            x = self.pool[i % len(self.pool)]
            logits, boxes, mem, idx = self.captured[i]
            shapes = rt.level_shapes(self.cfg, mem.shape[1])
            valid = rt.priors(shapes, "cpu")[1][0, :, 0].tolist()
            with ref.exact_f32(), torch.no_grad():
                for a in range(0, x.shape[0], BLOCK):
                    blk = slice(a, a + BLOCK)
                    r_mem, r_idx, _, _ = rt.folded_forward(self.cfg, self.tree, x[blk])
                    at = 0
                    for lvl, (h, w) in enumerate(shapes):
                        part = slice(at, at + h * w)
                        memory.add(lvl, mem[blk, part].float(), r_mem[:, part])
                        at += h * w
                    lost += missed(idx[blk], r_idx, valid)
                    chosen += r_idx.numel()
                    r_logits, r_boxes = rt.decoder_from(self.cfg, self.tree, r_mem, idx[blk])
                    decoder.add("logits", logits[blk].float(), r_logits)
                    decoder.add("boxes", boxes[blk].float(), r_boxes)
            threshold = self.cfg["conf_threshold"]
            with torch.no_grad():
                if self.variant == "control":
                    got = post.kept_rows(*rt.postprocess(logits, boxes, q, threshold,
                                                         torch.bfloat16))
                else:
                    got = post.kept_rows(*self.outputs[i])
                want = post.kept_rows(*rt.postprocess(logits.float(), boxes.float(), q,
                                                      threshold))
            b, t = post.mismatch(got, want)
            bad, total = bad + b, total + t
        return {"memory_rel_rms": memory.worst(), "select_missed": lost / max(chosen, 1),
                "decoder_rel_rms": decoder.worst(), "boxes_unmatched": bad / max(total, 1),
                "boxes_compared": float(total)}
