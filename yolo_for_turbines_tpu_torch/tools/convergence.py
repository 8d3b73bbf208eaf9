"""The JAX package's synthetic-set convergence and high-resolution recipes
through the port's ``train()``, and the trained checkpoint evaluated and
served.

    python -m yolo_for_turbines_tpu_torch.tools.convergence --recipe R1 --seeds 0 1 2
    python -m yolo_for_turbines_tpu_torch.tools.convergence --recipe R2 --seeds 0 --serve
    python -m yolo_for_turbines_tpu_torch.tools.convergence --recipe R3F --seeds 0
    python -m yolo_for_turbines_tpu_torch.tools.convergence --recipe R4 --finetune 832

R1 to R3F are ``benchmarks/convergence_run.py``'s runs: the 416-image
synthetic set (``data/synthetic.py``, seed 0) split 85 / 15, B = 32, mosaic,
the image cache, warmup then cosine decay, early stop after 30 evals
without a gain:

- ``R1``: Darknet-53 from scratch, lr 1e-3, 5% warmup, 550 steps, fixed
  416px (the JAX run: val mAP@0.5 0.949, ``benchmarks/RESULTS.md``, on-chip
  mosaic convergence run);
- ``R2``: CSPDarknet-53 from scratch, lr 5e-4, 10% warmup, 700 steps, fixed
  416px (the JAX run: 0.906; at lr 1e-3 with 5% warmup it diverged);
- ``R3``: the composed recipe, ``--kmeans-anchors --load-weights --mosaic
  --decay-lr --max-num-steps 700``: Darknet-53 at lr 1e-3, 5% warmup,
  multi-scale 416-608 buckets, k-means++ anchors from the set's own labels
  (proved to reach target assignment, :func:`check_custom_anchor_assignment`),
  and a seeded synthetic ``backbone.conv.74`` (:func:`write_backbone`)
  imported through the darknet binary path (the JAX run: 0.931);
- ``R3F``: R3 with ``--freeze-backbone``, the reference's primary recipe:
  the 37 imported conv layers frozen; after training every frozen
  parameter of the written checkpoint must equal the file's value bit for
  bit (:func:`check_frozen`; no JAX mAP exists for it).

R4 is ``benchmarks/hires_eval.py``'s base run: 416 seeded images at
1280x960 with 1 to 6 defects of 2-4.5% of the short side (split 85 / 15),
k-means++ anchors from its labels, lr 1e-3, 5% warmup, cosine,
multi-scale, the image cache, no mosaic, 700 steps at B = 32; its best
checkpoint is evaluated at 416, 608 and 832 (:func:`map_by_size`: the
device mAP of ``evaluate_map_device`` and the host ``calc_map`` of
``evaluate_map``; the JAX run: 0.567 / 0.811 / 0.192). ``--finetune 832``
then resumes that checkpoint in a fresh process, as ``hires_eval.py
--skip-train --finetune-size 832`` does: ``train(load_checkpoint=True)`` at
a fixed 832px, B = 8, lr 1e-4, no multi-scale, for ``--finetune-steps``
steps past the base checkpoint's step (440 by default; more counts chain,
each stage in its own process from the previous stage's best checkpoint),
the best checkpoint saved under the fine-tune's own identifier and
evaluated at the three sizes (the JAX run at +440: 0.458 / 0.749 /
0.293). The restore takes the checkpoint's step, optimizer and schedule
(``hyper``: the base run's warmup, 700 total steps and cosine) and
overrides only the peak lr, in both packages: past step 700 the lr is 0.

The sets are made once under ``--work-dir``. Each seed (``TrainConfig.seed``:
the seeded init) trains in a fresh process, which prints one JSON line: the
mAP of every 10th epoch's fused eval, the best, the train and val loss by
epoch, whether the trainer's NaN guard stopped the run, train()'s wall
seconds and the loader's host seconds per batch; the anchors and their
k-means mean IoU, the frozen count and check, the per-size mAP, and for a
fine-tune the restored step and schedule and the lr of every resumed step.
With ``--serve`` the process then loads the run's best checkpoint with
``inference.load_predictor_from_checkpoint`` and reads it on the val split
(:func:`serve_checkpoint`): the trainer's own mAP of the checkpoint (device
and host), the host mAP@0.5 of ``predict_batch``'s detections in bf16 and,
after ``Predictor.quantize`` on 8 train images, in int8, the survivors per
image, the kernel launches per call, and how far the bf16 heads sit from a
float32 predictor's (:func:`heads_vs_f32`). The last process of a seed
deletes its checkpoints and logs. The size flags shrink a run (the CPU
tests run the tiny backbone at 64px); ``--compute-dtype float32`` trains
with TF32 off. Needs a CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from .. import config as cfg

REPO = Path(__file__).resolve().parents[2]
WORK_DIR = REPO / "_smoke" / "convergence"
SPLIT = {"train": 0.85, "val": 0.15}
SET_SEED = 0
# hires_eval.py's small-defect set (its generate_synthetic_dataset call)
HIRES_SET = {"image_size": (1280, 960), "max_objects": 6, "box_frac": (0.02, 0.045)}
EARLY_STOP = 30  # benchmarks/convergence_run.py's --early-stop
NUM_WORKERS = 8
CALIB_IMAGES = 8
IDENTIFIER = "converge"
KMEANS_K = 9
# convergence_run.py writes its synthetic backbone from a seeded init of the
# model train() builds (its PRNGKey(7)); the port's init is drawn from a
# torch.Generator of the same seed
BACKBONE_SEED = 7
BACKBONE_FILE = "backbone.conv.74"
# _check_frozen_leaves loads the file into a model of another seed, so that
# a leaf the file did not fill cannot match by chance
FROZEN_CHECK_SEED = 1234
# the parameters a .conv.74 file freezes in Darknet-53: the cutoff counts
# each BN and each conv as a layer, so 37 conv layers, 3 parameters each
# (conv weight, BN scale and bias); the count of JAX's mask leaves, pinned
# by tests/test_torch_finetune.py
FROZEN_CONV74 = 111
# convergence_run.py's anchor check: the first 8 label files at 416px
ANCHOR_CHECK_FILES = 8
ANCHOR_CHECK_GRIDS = (13, 26, 52)


@dataclasses.dataclass(frozen=True)
class Finetune:
    """``hires_eval.py``'s fixed-size fine-tune of a base checkpoint, and
    the val mAP@0.5 its JAX run reached per eval size after ``steps``."""

    size: int = 832
    lr: float = 1e-4
    batch_size: int = 8
    steps: Tuple[int, ...] = (440,)
    jax_map_by_size: Tuple[Tuple[int, Tuple[float, ...]], ...] = ((440, (0.458, 0.749, 0.293)),)

    def train_config(self, total_steps: int, **overrides) -> cfg.TrainConfig:
        """``hires_eval.py``'s TrainConfig for ``--finetune-size`` with
        ``--finetune-total-steps total_steps``."""
        fields = dict(lr=self.lr, batch_size=self.batch_size, max_num_steps=total_steps,
                      multi_scale=False, image_size=self.size, cache_images=True,
                      load_checkpoint=True)
        fields.update(overrides)
        return cfg.TrainConfig(**fields)


@dataclasses.dataclass(frozen=True)
class Recipe:
    """One run on a synthetic set, and the val mAP@0.5 its JAX run reached
    (None where JAX has none)."""

    name: str
    backbone: str
    lr: float
    warmup: float
    max_num_steps: int
    jax_best_map: Optional[float]
    num_images: int = 416
    batch_size: int = 32
    mosaic: bool = True
    multi_scale: bool = False
    kmeans_anchors: bool = False
    load_weights: bool = False
    freeze_backbone: bool = False
    hires: bool = False  # hires_eval.py's set
    eval_sizes: Tuple[int, ...] = ()
    jax_map_by_size: Tuple[float, ...] = ()
    finetune: Optional[Finetune] = None

    def train_config(self, **overrides) -> cfg.TrainConfig:
        """The driver's TrainConfig: ``convergence_run.py``'s for ``--decay-lr``
        and this recipe's flags, or ``hires_eval.py``'s (whose other fields
        are the defaults that convergence_run.py passes)."""
        fields = dict(lr=self.lr, batch_size=self.batch_size,
                      max_num_steps=self.max_num_steps, multi_scale=self.multi_scale,
                      mosaic=self.mosaic, cache_images=True, load_checkpoint=False,
                      decay_lr=True, warmup=self.warmup,
                      load_weights=self.load_weights or self.freeze_backbone,
                      freeze_backbone=self.freeze_backbone)
        fields.update(overrides)
        return cfg.TrainConfig(**fields)

    @property
    def anchors(self):
        """The default anchors: tiny's two scales for ``yolov3_tiny`` (a
        size-cut run), else the turbine anchors (k-means recipes replace
        them, :func:`run_anchors`)."""
        return cfg.TINY_ANCHORS if self.backbone == "yolov3_tiny" else cfg.TURBINE_ANCHORS

    def model_config(self) -> cfg.ModelConfig:
        """The model ``train()`` builds for this recipe."""
        return cfg.ModelConfig(num_classes=cfg.NUM_TURBINE_CLASSES,
                               activation=cfg.TrainConfig.activation, backbone=self.backbone,
                               strides=cfg.strides_for(self.backbone))

    def set_dir(self, work: Path) -> Path:
        return Path(work) / ("data_hires" if self.hires else "data")


R1 = Recipe("R1", "darknet53", lr=1e-3, warmup=0.05, max_num_steps=550, jax_best_map=0.949)
R2 = Recipe("R2", "cspdarknet53", lr=5e-4, warmup=0.1, max_num_steps=700, jax_best_map=0.906)
R3 = Recipe("R3", "darknet53", lr=1e-3, warmup=0.05, max_num_steps=700, jax_best_map=0.931,
            multi_scale=True, kmeans_anchors=True, load_weights=True)
R3F = dataclasses.replace(R3, name="R3F", freeze_backbone=True, jax_best_map=None)
R4 = Recipe("R4", "darknet53", lr=1e-3, warmup=0.05, max_num_steps=700, jax_best_map=0.567,
            mosaic=False, multi_scale=True, kmeans_anchors=True, hires=True,
            eval_sizes=(416, 608, 832), jax_map_by_size=(0.567, 0.811, 0.192),
            finetune=Finetune())
RECIPES = {r.name: r for r in (R1, R2, R3, R3F, R4)}


def make_set(root, num_images: int, hires: bool = False) -> Path:
    """A recipe's set under ``root``: ``num_images`` synthetic JPEGs (seed
    0; ``hires``: ``hires_eval.py``'s 1280x960 small-defect set) and the
    85 / 15 split CSVs, as the JAX drivers write them; kept when ``root``
    already holds them."""
    from ..data.splits import create_csv_files
    from ..data.synthetic import generate_synthetic_dataset

    root = Path(root)
    if not (root / "train.csv").exists():
        generate_synthetic_dataset(root, num_images=num_images, seed=SET_SEED,
                                   **(HIRES_SET if hires else {}))
        create_csv_files(root / "images", root / "labels", root, SPLIT, image_ext=".jpg")
    return root


def folders(root: Path) -> dict:
    return {"image_folder": root / "images", "annotation_folder": root / "labels"}


def check_custom_anchor_assignment(anchors, root: Path) -> dict:
    """``convergence_run.py::_assert_custom_anchor_assignment``: custom
    anchors reach the target encoder, shown two ways on the first
    ``ANCHOR_CHECK_FILES`` label files.

    1. For the first box of each file, the best of the 9 anchors by wh-IoU,
       recomputed by ``tools/anchors.py::iou_wh`` (not the encoder's own
       IoU), must own objectness 1 in exactly its (scale, anchor, cell)
       slot of ``assign_targets``' encoding (the first box always wins its
       best anchor: nothing is taken yet).
    2. The objectness masks must differ somewhere from the encoding under
       the default turbine anchors, or the custom anchors prove nothing.

    Raises ``ValueError`` when either fails."""
    from ..data.dataset import assign_targets
    from .anchors import iou_wh

    flat = np.asarray(anchors, np.float64).reshape(-1, 2)
    flat_default = np.asarray(cfg.TURBINE_ANCHORS, np.float64).reshape(-1, 2)
    per_scale = len(flat) // len(ANCHOR_CHECK_GRIDS)
    n_checked, diverged = 0, False
    for lbl in sorted((Path(root) / "labels").glob("*.txt"))[:ANCHOR_CHECK_FILES]:
        rows = np.loadtxt(lbl).reshape(-1, 5)
        boxes = np.roll(rows, shift=4, axis=1)
        tgts = assign_targets(boxes, flat, ANCHOR_CHECK_GRIDS)
        x, y, w, h, _ = boxes[0]
        best = int(np.argmax(iou_wh(np.asarray([[w, h]]), flat)[0]))
        sc, ai = best // per_scale, best % per_scale
        s = ANCHOR_CHECK_GRIDS[sc]
        i, j = min(int(s * y), s - 1), min(int(s * x), s - 1)
        if tgts[sc][ai, i, j, 4] != 1:
            raise ValueError(f"{lbl.name}: best custom anchor {best} (scale {sc} slot {ai} "
                             f"cell {i},{j}) did not receive box 0")
        n_checked += 1
        tgts_default = assign_targets(boxes, flat_default, ANCHOR_CHECK_GRIDS)
        diverged = diverged or any(not np.array_equal(a[..., 4], b[..., 4])
                                   for a, b in zip(tgts, tgts_default))
    if not n_checked:
        raise ValueError(f"no label files to check under {root}")
    if not diverged:
        raise ValueError("custom anchors produced identical assignments to the defaults on "
                         "every checked file: the custom anchors would prove nothing")
    return {"anchor_assignment_spot_checks": n_checked,
            "anchor_assignment_diverges_from_default": True}


def run_anchors(recipe: Recipe, root: Path):
    """``(anchors (3, 3, 2), meta)``: k-means++ on the set's own labels
    (``k = 9``, grouped 3 per scale, checked to reach target assignment)
    for a k-means recipe, as the JAX drivers compute them; else the
    recipe's default anchors."""
    if not recipe.kmeans_anchors:
        return np.asarray(recipe.anchors, np.float32), {"anchors_source": "default"}
    from .anchors import group_by_scale, kmeans_anchors, load_wh_boxes

    whs = load_wh_boxes(root / "labels")
    centroids, mean_iou = kmeans_anchors(whs, k=KMEANS_K)
    anchors = np.asarray(group_by_scale(centroids), np.float32)
    meta = {"anchors_source": "kmeans++ on run labels", "kmeans_mean_iou": mean_iou,
            "kmeans_num_boxes": int(len(whs)), "anchors": anchors.tolist()}
    meta.update(check_custom_anchor_assignment(anchors, root))
    return anchors, meta


def write_backbone(path, model_cfg: cfg.ModelConfig) -> Path:
    """The synthetic stand-in for the official ``darknet53.conv.74``: the
    port's seeded init of ``model_cfg`` (``BACKBONE_SEED``) written whole
    in the darknet binary format (``export_darknet_weights``); the loader
    parses the cutoff 74 from the file name, as for the official file.
    Kept when ``path`` exists."""
    from ..models.convert import trainable_to_numpy
    from ..models.darknet_weights import export_darknet_weights
    from ..models.yolov3 import YOLOv3

    path = Path(path)
    if not path.exists():
        model = YOLOv3(model_cfg, generator=torch.Generator().manual_seed(BACKBONE_SEED))
        params, stats = trainable_to_numpy(model)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        try:
            export_darknet_weights(model.plan, params, stats, str(tmp))
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)
    return path


def check_frozen(ckpt, weights_path, model_cfg: cfg.ModelConfig, seed: int) -> dict:
    """``convergence_run.py::_check_frozen_leaves`` for a checkpoint of a
    frozen run: every parameter that ``load_darknet_into(freeze=True)``
    freezes, loaded into a model of another seed (``FROZEN_CHECK_SEED``),
    must equal the checkpoint's bit for bit. Beside it, the parameters left
    trainable are compared with the run's own start (``seed``'s init with
    the file loaded): those still equal to it did not move."""
    from ..models.darknet_weights import load_darknet_into
    from ..models.yolov3 import YOLOv3

    ref = YOLOv3(model_cfg, generator=torch.Generator().manual_seed(FROZEN_CHECK_SEED))
    names, _ = load_darknet_into(str(weights_path), ref, freeze=True)
    start = YOLOv3(model_cfg, generator=torch.Generator().manual_seed(seed))
    load_darknet_into(str(weights_path), start)
    trained = torch.load(Path(ckpt), map_location="cpu", weights_only=True)["model"]
    ref_p, start_p = dict(ref.named_parameters()), dict(start.named_parameters())
    frozen = set(names)
    changed = [n for n in names if not torch.equal(trained[n], ref_p[n])]
    unmoved = [n for n in start_p if n not in frozen and torch.equal(trained[n], start_p[n])]
    return {"frozen_count": len(names), "frozen_changed": changed,
            "frozen_bitwise_unchanged": bool(names) and not changed,
            "unfrozen_count": len(start_p) - len(frozen), "unfrozen_unmoved": unmoved}


def loader_seconds_per_batch(root: Path, tc: cfg.TrainConfig, recipe: Recipe, anchors) -> float:
    """Host seconds per train batch of the recipe's loader (decode or cache,
    mosaic, the C++ augmenter, collate) at ``tc.image_size``, timed over a
    second pass: the first fills the image cache, as train()'s first epoch
    does."""
    from ..data.loader import get_loaders

    train_loader, _, _ = get_loaders(
        root, batch_size=tc.batch_size, anchors=anchors, num_workers=NUM_WORKERS,
        mosaic=tc.mosaic, cache_images=tc.cache_images, image_size=tc.image_size,
        strides=recipe.model_config().strides, **folders(root))
    sum(1 for _ in train_loader)
    t0 = time.perf_counter()
    n = sum(1 for _ in train_loader)
    return (time.perf_counter() - t0) / max(n, 1)


def metrics_rows(models: Path, identifier: str = IDENTIFIER) -> list:
    path = models / f"YOLOv3_Turbine_Detection_{identifier}_metrics.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []


def checkpoint_path(models: Path, identifier: str = IDENTIFIER) -> Path:
    return models / f"best_model_{identifier}.ckpt"


def _finite(v: float):
    return v if np.isfinite(v) else str(v)


def _train(tc, recipe: Recipe, root: Path, models: Path, identifier: str, device, anchors,
           report_callback=None, **kw) -> dict:
    """``train()`` of ``tc`` with logs and the best checkpoint under
    ``models``; a stop on the NaN guard is a result (``nan_stop``), not an
    error."""
    from ..train.trainer import train

    nan_stop = False
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # the metrics logger prints each row
        try:
            train(tc, root, models, identifier, early_stop=EARLY_STOP,
                  report_callback=report_callback, num_workers=NUM_WORKERS,
                  anchors=anchors, backbone=recipe.backbone, device=device,
                  **folders(root), **kw)
        except ValueError as e:
            if "Nan loss" not in str(e):
                raise
            nan_stop = True
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    rows = metrics_rows(models, identifier)
    maps = [r["mAP"] for r in rows if "mAP" in r]
    ckpt = checkpoint_path(models, identifier)
    return {
        "lr": tc.lr, "warmup": tc.warmup, "max_num_steps": tc.max_num_steps,
        "batch_size": tc.batch_size, "image_size": tc.image_size,
        "multi_scale": tc.multi_scale, "mosaic": tc.mosaic,
        "compute_dtype": tc.compute_dtype, "nan_stop": nan_stop,
        "best_map": max(maps, default=0.0), "map_trajectory": maps,
        "train_loss_by_epoch": [_finite(r["train_loss"]) for r in rows if "train_loss" in r],
        "val_loss_by_epoch": [_finite(r["val_loss"]) for r in rows if "val_loss" in r],
        "lr_by_step": [r["lr"] for r in rows if "lr" in r],
        "steps": sum("lr" in r for r in rows), "wall_s": wall,
        "checkpoint": str(ckpt),
        "checkpoint_step": (int(torch.load(ckpt, map_location="cpu", weights_only=True)["step"])
                            if ckpt.exists() else None),
    }


def run_recipe(recipe: Recipe, seed: int, root: Path, models: Path, device,
               report_callback=None, anchors=None, anchor_meta=None, **overrides) -> dict:
    """``train()`` of ``recipe`` with ``TrainConfig.seed = seed`` on the set
    at ``root``, logs and checkpoint under ``models`` (emptied first), the
    recipe's anchors (:func:`run_anchors` unless given) and, for a recipe
    that loads weights, its synthetic ``backbone.conv.74`` under ``root``;
    a frozen run's checkpoint is checked by :func:`check_frozen`."""
    tc = recipe.train_config(seed=seed, **overrides)
    if anchors is None:
        anchors, anchor_meta = run_anchors(recipe, root)
    shutil.rmtree(models, ignore_errors=True)
    weights_path = None
    if tc.load_weights:
        weights_path = write_backbone(root / BACKBONE_FILE, recipe.model_config())
    loader_s = loader_seconds_per_batch(root, tc, recipe, anchors)
    r = {"recipe": recipe.name, "backbone": recipe.backbone, "seed": seed,
         "jax_best_map": recipe.jax_best_map, "load_weights": tc.load_weights,
         "freeze_backbone": tc.freeze_backbone, **(anchor_meta or {})}
    r.update(_train(tc, recipe, root, models, IDENTIFIER, device, anchors, report_callback,
                    weights_path=weights_path))
    r["loader_s_per_batch"] = loader_s
    r["frozen_count"] = 0
    if tc.freeze_backbone and Path(r["checkpoint"]).exists():
        r["frozen"] = check_frozen(r["checkpoint"], weights_path, recipe.model_config(), seed)
        r["frozen_count"] = r["frozen"]["frozen_count"]
    return r


_BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def run_finetune(recipe: Recipe, seed: int, root: Path, models: Path, base_ckpt,
                 base_step: int, steps_past: int, device, anchors, anchor_meta=None,
                 report_callback=None, weights_path=None, **overrides) -> dict:
    """``hires_eval.py``'s fine-tune: ``train(load_checkpoint=True)`` of the
    recipe's :class:`Finetune` config restoring ``base_ckpt`` (the restore
    source), for ``max_num_steps = base_step + steps_past``,
    the best checkpoint saved under the fine-tune's own identifier. The
    restored step and schedule, and the lr of every step taken, are read
    back: the first step's lr is the restored schedule's at the restored
    step, with the fine-tune's peak lr. A frozen base resumes frozen: pass
    its ``weights_path`` and ``load_weights=True, freeze_backbone=True``,
    so that the optimizer holds the parameter groups the checkpoint's
    does."""
    from ..train.steps import scheduled_lr

    ft = recipe.finetune
    tc = ft.train_config(base_step + steps_past, seed=seed, **overrides)
    base_ckpt = Path(base_ckpt)
    payload = torch.load(base_ckpt, map_location="cpu", weights_only=True)
    restored_step = int(payload["step"])
    hyper = {k: float(v) for k, v in payload["hyper"].items()}
    identifier = f"{IDENTIFIER}_ft{ft.size}_{steps_past}"
    r = {"recipe": f"{recipe.name}-ft{ft.size}", "backbone": recipe.backbone, "seed": seed,
         "steps_past_base": steps_past, "base_step": base_step,
         "restored_from": base_ckpt.name, "restored_step": restored_step,
         "restored_hyper": hyper,
         **(anchor_meta or {})}
    r.update(_train(tc, recipe, root, models, identifier, device, anchors, report_callback,
                    checkpoint_name=str(base_ckpt.resolve()), weights_path=weights_path))
    want_hyper = dict(hyper, lr=tc.lr)
    want_lrs = [scheduled_lr(restored_step + i, want_hyper) for i in range(r["steps"])]
    r["first_resumed_lr"] = r["lr_by_step"][0] if r["lr_by_step"] else None
    r["lr_by_step_is_restored_schedule"] = r["lr_by_step"] == want_lrs
    r["lr_zero_from_step"] = next((restored_step + i for i, v in enumerate(want_lrs) if v == 0.0),
                                  None)
    ckpt = Path(r["checkpoint"])
    if ckpt.exists():
        saved = torch.load(ckpt, map_location="cpu", weights_only=True)
        r["saved_hyper"] = {k: float(v) for k, v in saved["hyper"].items()}
        r["saved_hyper_is_restored"] = r["saved_hyper"] == want_hyper
        # what the fine-tune changed: at lr 0 the parameters stay and only
        # the BN running statistics (buffers) move
        moved = [n for n, v in saved["model"].items() if not torch.equal(v, payload["model"][n])]
        buffers = [n for n in moved if n.endswith(_BN_BUFFERS)]
        r["moved_parameters"] = len(moved) - len(buffers)
        r["moved_bn_buffers"] = len(buffers)
    return r


def map_by_size(ckpt, root: Path, recipe: Recipe, anchors, device, sizes,
                compute_dtype: str = "bfloat16") -> dict:
    """The checkpoint at each of ``sizes`` on the val split, as
    ``hires_eval.py`` reads it: a val loader at the size (B = the recipe's),
    ``evaluate_map_device`` (boxes and mAP on the device) and, beside it,
    ``evaluate_map`` (host ``calc_map``); each pass launches K1 once per
    val batch on CUDA."""
    from ..data.loader import get_loaders
    from ..models.yolov3 import YOLOv3
    from ..ops.kernels import nms_kernel
    from ..train.checkpoint import load_model_state
    from ..train.evaluate import evaluate_map, evaluate_map_device
    from ..train.steps import compute_dtype_of

    model_cfg = recipe.model_config()
    model = YOLOv3(model_cfg, generator=torch.Generator().manual_seed(0))
    load_model_state(model, ckpt)
    device = torch.device(device)
    model = (model.to(device, memory_format=torch.channels_last) if device.type == "cuda"
             else model.to(device))
    dtype = compute_dtype_of(compute_dtype)
    out = {}
    for size in sizes:
        _, val_loader, _ = get_loaders(root, batch_size=recipe.batch_size, anchors=anchors,
                                       num_workers=NUM_WORKERS, image_size=size,
                                       strides=model_cfg.strides, **folders(root))
        before = nms_kernel.launches
        t0 = time.perf_counter()
        dev_map = evaluate_map_device(val_loader, model, anchors, model_cfg.num_classes,
                                      compute_dtype=dtype)
        eval_s = time.perf_counter() - t0
        host_map = evaluate_map(val_loader, model, anchors, model_cfg.num_classes,
                                compute_dtype=dtype)
        out[str(size)] = {"device_map": dev_map, "host_map": host_map, "eval_s": eval_s,
                          "val_batches": len(val_loader),
                          "k1_launches": nms_kernel.launches - before}
    return out


def _kernel_counts() -> dict:
    from ..ops.kernels import nms_kernel, resblock_int8_kernel, resblock_kernel

    return {"greedy_nms": nms_kernel.launches,
            "fused_residual_stage": resblock_kernel.launches,
            "fused_residual_stage_int8": resblock_int8_kernel.launches}


def served_map(pred, val_loader, num_classes: int) -> dict:
    """Host mAP@0.5 (``calc_map``) of ``pred.predict_batch``'s detections
    over ``val_loader``, against the trainer's ground-truth rows; the
    survivors per image and the kernel launches per call."""
    from ..ops.map import calc_map
    from ..train.evaluate import _top_ground_truth, rows_from_eval_step

    preds, trues, survivors = [], [], []
    idx = calls = 0
    before = _kernel_counts()
    for x, y in val_loader:
        kept, mask = pred.predict_batch(x)
        calls += 1
        fine = torch.as_tensor(y[-1], device=pred.device)
        grid = fine.shape[2]
        scaled = torch.as_tensor(pred.anchors[-1] * grid, device=pred.device)
        true = _top_ground_truth(fine, scaled, grid, 128)
        p, t, idx = rows_from_eval_step(kept, mask, true, idx, pred.conf_threshold)
        preds.extend(p)
        trues.extend(t)
        survivors.extend(mask.sum(1).tolist())
    if pred.device.type == "cuda":
        torch.cuda.synchronize(pred.device)
    launches = {k: (v - before[k]) / max(calls, 1) for k, v in _kernel_counts().items()}
    return {"map": calc_map(preds, trues, iou_threshold=cfg.MAP_IOU_THRESHOLD,
                            box_format="center", num_classes=num_classes),
            "survivors_per_image": float(np.mean(survivors)),
            "survivors_min_max": [int(min(survivors)), int(max(survivors))],
            "calls": calls, "launches_per_call": launches,
            "compute_dtype": str(pred.compute_dtype).replace("torch.", "")}


def serve_checkpoint(ckpt, root: Path, recipe: Recipe, device, anchors=None,
                     image_size: Optional[int] = None, int8: bool = True,
                     **overrides) -> dict:
    """The checkpoint of a run of ``recipe`` (with ``overrides`` of its
    TrainConfig) on the val split at ``image_size`` (the config's unless
    given), with ``anchors`` (the recipe's defaults unless given): the
    trainer's own fused eval of it (device mAP and host ``calc_map``), then
    served by ``load_predictor_from_checkpoint`` in bf16 and, with
    ``int8``, in int8 (module docstring)."""
    from ..data.augment import test_transforms
    from ..data.dataset import YOLODataset
    from ..data.loader import get_loaders
    from ..inference import load_predictor_from_checkpoint
    from ..train.checkpoint import load_model_state
    from ..train.trainer import Trainer

    tc = recipe.train_config(**overrides)
    image_size = tc.image_size if image_size is None else image_size
    anchors = np.asarray(recipe.anchors if anchors is None else anchors, np.float32)
    model_cfg = recipe.model_config()
    _, val_loader, _ = get_loaders(root, batch_size=tc.batch_size, anchors=anchors,
                                   num_workers=NUM_WORKERS, image_size=image_size,
                                   strides=model_cfg.strides, **folders(root))
    out = {"image_size": image_size, "val_images": len(val_loader.dataset),
           "val_batches": len(val_loader)}

    class _Drop:
        def log(self, d):
            pass

    # the eval reads the module alone (weights and running statistics)
    for name, device_eval in (("device", True), ("host", False)):
        trainer = Trainer(dataclasses.replace(tc, device_eval=device_eval), model_cfg,
                          anchors=anchors, device=device)
        load_model_state(trainer.model, ckpt)
        out[f"trainer_map_{name}"] = trainer.val_one_epoch(val_loader, 9, _Drop())[1]
        del trainer

    pred = load_predictor_from_checkpoint(ckpt, num_classes=model_cfg.num_classes,
                                          activation=model_cfg.activation,
                                          anchors=anchors, image_size=image_size,
                                          backbone=recipe.backbone,
                                          device=device)
    out["served_bf16"] = served_map(pred, val_loader, model_cfg.num_classes)
    out["heads_vs_f32"] = heads_vs_f32(pred, next(iter(val_loader))[0])
    out["served_bf16_minus_trainer"] = out["served_bf16"]["map"] - out["trainer_map_device"]
    if int8:
        calib_ds = YOLODataset(root / "train.csv", root / "images", root / "labels",
                               anchors, image_size=image_size,
                               grid_sizes=cfg.grid_sizes_for(image_size, model_cfg.strides),
                               num_classes=model_cfg.num_classes,
                               transform=test_transforms(image_size))
        calib = np.stack([calib_ds[i][0] for i in range(CALIB_IMAGES)])
        pred.quantize(calib)
        out["served_int8"] = served_map(pred, val_loader, model_cfg.num_classes)
        out["calib_images"] = CALIB_IMAGES
    return out


def heads_vs_f32(pred, x) -> float:
    """The worst relative RMS, over the heads, of ``pred``'s raw heads on
    the batch ``x`` against a float32 predictor (TF32 off) of the same
    folded tree: how far the compute dtype moves trained heads."""
    from ..inference import Predictor
    from ..models.blocks import full_f32

    f32 = Predictor.from_folded(pred.model.cfg, pred.full_precision_tree(), device=pred.device,
                                anchors=pred.anchors, compute_dtype=torch.float32)
    with full_f32():
        want = f32.raw_heads(x)
    got = pred.raw_heads(x)
    return max(float(torch.linalg.vector_norm(g.float() - w) / torch.linalg.vector_norm(w))
               for g, w in zip(got, want))


def _overrides(args) -> dict:
    return {k: v for k, v in (("batch_size", args.batch_size),
                              ("max_num_steps", args.max_num_steps),
                              ("image_size", args.image_size),
                              ("compute_dtype", args.compute_dtype)) if v is not None}


def child(args) -> None:
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    recipe = RECIPES[args.recipe]
    if args.backbone:
        recipe = dataclasses.replace(recipe, backbone=args.backbone)
    if args.eval_sizes:
        recipe = dataclasses.replace(recipe, eval_sizes=tuple(args.eval_sizes))
    if args.finetune:
        ft = dataclasses.replace(recipe.finetune, size=args.finetune)
        if args.finetune_batch_size:
            ft = dataclasses.replace(ft, batch_size=args.finetune_batch_size)
        recipe = dataclasses.replace(recipe, finetune=ft)
    overrides = _overrides(args)
    work = Path(args.work_dir)
    root = recipe.set_dir(work)
    models = work / f"models_{args.recipe}_s{args.seed}"
    try:
        anchors, anchor_meta = run_anchors(recipe, root)
        if args.finetune_from:
            # the fine-tune's size and batch are its own (--finetune, and
            # --finetune-batch-size for a size-cut run)
            ft_over = {k: v for k, v in overrides.items() if k == "compute_dtype"}
            r = run_finetune(recipe, args.seed, root, models, args.finetune_from,
                             args.finetune_base_step, args.finetune_steps_past, device,
                             anchors, anchor_meta, **ft_over)
        else:
            r = run_recipe(recipe, args.seed, root, models, device, anchors=anchors,
                           anchor_meta=anchor_meta, **overrides)
        ckpt = Path(r["checkpoint"])
        if recipe.eval_sizes and ckpt.exists():
            with contextlib.redirect_stdout(sys.stderr):
                r["map_by_size"] = map_by_size(ckpt, root, recipe, anchors, device,
                                               recipe.eval_sizes,
                                               overrides.get("compute_dtype", "bfloat16"))
            # JAX's numbers at the recipe's own sizes (none for other sizes)
            jax_maps = (dict(recipe.finetune.jax_map_by_size).get(args.finetune_steps_past, ())
                        if args.finetune_from else recipe.jax_map_by_size)
            r["jax_map_by_size"] = dict(zip(map(str, RECIPES[args.recipe].eval_sizes), jax_maps))
        if args.serve and ckpt.exists():
            with contextlib.redirect_stdout(sys.stderr):
                r["serve"] = serve_checkpoint(ckpt, root, recipe, device, anchors=anchors,
                                              **overrides)
        print(json.dumps(r), flush=True)
    finally:
        if not args.keep:
            shutil.rmtree(models, ignore_errors=True)


def _stage(passed, seed: int, *extra) -> dict:
    """One child process; its last stdout line (one JSON object) is
    printed and returned."""
    cmd = [sys.executable, "-m", "yolo_for_turbines_tpu_torch.tools.convergence",
           *passed, "--seed", str(seed), *extra]
    done = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, check=True, cwd=REPO)
    line = done.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    return json.loads(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--recipe", choices=sorted(RECIPES), default="R1")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--serve", action="store_true",
                    help="read each run's best checkpoint served, bf16 and int8")
    ap.add_argument("--finetune", type=int, default=None, metavar="SIZE",
                    help="resume each seed's best checkpoint at this fixed size in a fresh "
                         "process (hires_eval.py --skip-train --finetune-size)")
    ap.add_argument("--finetune-steps", type=int, nargs="+", default=None,
                    help="steps past the base checkpoint's step, one stage each, chained "
                         "(default: the recipe's, 440)")
    ap.add_argument("--finetune-batch-size", type=int, default=None)
    ap.add_argument("--eval-sizes", type=int, nargs="+", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work-dir", default=str(WORK_DIR))
    ap.add_argument("--num-images", type=int, default=None)
    ap.add_argument("--backbone", default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--max-num-steps", type=int, default=None)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--compute-dtype", choices=("bfloat16", "float32"), default=None)
    # a child process's own arguments
    ap.add_argument("--seed", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--keep", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--finetune-from", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--finetune-base-step", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--finetune-steps-past", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.seed is not None:
        child(args)
        return 0
    torch.device(args.device)  # refuse a bad device name before any work
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("the recipes run on CUDA and no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    recipe = RECIPES[args.recipe]
    if args.finetune and recipe.finetune is None:
        raise SystemExit(f"--finetune: recipe {recipe.name} has no fine-tune stage (R4 has)")
    make_set(recipe.set_dir(Path(args.work_dir)), args.num_images or recipe.num_images,
             recipe.hires)
    skip = ("seeds", "serve", "seed", "keep", "finetune_steps", "finetune_from",
            "finetune_base_step", "finetune_steps_past")
    passed = [f"--{k.replace('_', '-')}={v}" for k, v in vars(args).items()
              if v is not None and v is not False and k not in skip and k != "eval_sizes"]
    passed += ["--serve"] * args.serve
    if args.eval_sizes:
        passed += ["--eval-sizes", *map(str, args.eval_sizes)]
    stages = (args.finetune_steps or list(recipe.finetune.steps)) if args.finetune else []
    for seed in args.seeds:
        base = _stage(passed, seed, *(["--keep"] if stages else []))
        src, base_step = base["checkpoint"], base["checkpoint_step"]
        if stages and base_step is None:
            raise SystemExit(f"seed {seed}: the base run wrote no checkpoint to resume")
        for i, steps_past in enumerate(stages):
            last = i == len(stages) - 1
            r = _stage(passed, seed, "--finetune-from", src,
                       "--finetune-base-step", str(base_step),
                       "--finetune-steps-past", str(steps_past), *([] if last else ["--keep"]))
            src = r["checkpoint"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
