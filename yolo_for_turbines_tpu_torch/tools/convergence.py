"""The JAX package's synthetic-set convergence recipes through the port's
``train()``, and the trained checkpoint served.

    python -m yolo_for_turbines_tpu_torch.tools.convergence --recipe R1 --seeds 0 1 2
    python -m yolo_for_turbines_tpu_torch.tools.convergence --recipe R2 --seeds 0 --serve

A recipe is ``benchmarks/convergence_run.py``'s run of one backbone from
scratch: the 416-image synthetic set (``data/synthetic.py``, seed 0) split
85 / 15, B = 32, mosaic at a fixed 416px, the image cache, warmup then
cosine decay, early stop after 30 evals without a gain:

- ``R1``: Darknet-53, lr 1e-3, 5% warmup, 550 steps (the JAX run: val
  mAP@0.5 0.949, ``benchmarks/RESULTS.md``, on-chip mosaic convergence run);
- ``R2``: CSPDarknet-53, lr 5e-4, 10% warmup, 700 steps (the JAX run:
  0.906; at lr 1e-3 with 5% warmup it diverged).

The set is made once under ``--work-dir``. Each seed (``TrainConfig.seed``:
the seeded init) trains in a fresh process, which prints one JSON line: the
mAP of every 10th epoch's fused eval, the best, the train and val loss by
epoch, whether the trainer's NaN guard stopped the run, train()'s wall
seconds and the loader's host seconds per batch. With ``--serve`` the
process then loads the run's best checkpoint with
``inference.load_predictor_from_checkpoint`` and reads it on the val split
(:func:`serve_checkpoint`): the trainer's own mAP of the checkpoint (device
and host), the host mAP@0.5 of ``predict_batch``'s detections in bf16 and,
after ``Predictor.quantize`` on 8 train images, in int8, the survivors per
image, the kernel launches per call, and how far the bf16 heads sit from
a float32 predictor's (:func:`heads_vs_f32`). The process deletes the
run's checkpoint and logs before it ends. The size flags shrink a run
(the CPU test runs the tiny backbone at 64px); ``--compute-dtype float32``
trains with TF32 off. Needs a CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import config as cfg

REPO = Path(__file__).resolve().parents[2]
WORK_DIR = REPO / "_smoke" / "convergence"
SPLIT = {"train": 0.85, "val": 0.15}
SET_SEED = 0
EARLY_STOP = 30  # benchmarks/convergence_run.py's --early-stop
NUM_WORKERS = 8
CALIB_IMAGES = 8
IDENTIFIER = "converge"


@dataclasses.dataclass(frozen=True)
class Recipe:
    """One backbone's from-scratch run on the synthetic set, and the val
    mAP@0.5 its JAX run reached."""

    name: str
    backbone: str
    lr: float
    warmup: float
    max_num_steps: int
    jax_best_map: float
    num_images: int = 416
    batch_size: int = 32

    def train_config(self, **overrides) -> cfg.TrainConfig:
        """``convergence_run.py``'s TrainConfig for ``--mosaic
        --no-multi-scale --decay-lr`` and this recipe's lr, warmup and
        steps."""
        fields = dict(lr=self.lr, batch_size=self.batch_size,
                      max_num_steps=self.max_num_steps, multi_scale=False, mosaic=True,
                      cache_images=True, load_checkpoint=False, decay_lr=True,
                      warmup=self.warmup, load_weights=False, freeze_backbone=False)
        fields.update(overrides)
        return cfg.TrainConfig(**fields)

    @property
    def anchors(self):
        """The anchors train() gets: tiny's two scales for ``yolov3_tiny``
        (a size-cut run), else the default turbine anchors."""
        return cfg.TINY_ANCHORS if self.backbone == "yolov3_tiny" else cfg.TURBINE_ANCHORS

    def model_config(self) -> cfg.ModelConfig:
        """The model ``train()`` builds for this recipe."""
        return cfg.ModelConfig(num_classes=cfg.NUM_TURBINE_CLASSES,
                               activation=cfg.TrainConfig.activation, backbone=self.backbone,
                               strides=cfg.strides_for(self.backbone))


R1 = Recipe("R1", "darknet53", lr=1e-3, warmup=0.05, max_num_steps=550, jax_best_map=0.949)
R2 = Recipe("R2", "cspdarknet53", lr=5e-4, warmup=0.1, max_num_steps=700, jax_best_map=0.906)
RECIPES = {r.name: r for r in (R1, R2)}


def make_set(root, num_images: int) -> Path:
    """The recipe's set under ``root``: ``num_images`` synthetic JPEGs
    (seed 0) and the 85 / 15 split CSVs, as ``convergence_run.py`` writes
    them; kept when ``root`` already holds them."""
    from ..data.splits import create_csv_files
    from ..data.synthetic import generate_synthetic_dataset

    root = Path(root)
    if not (root / "train.csv").exists():
        generate_synthetic_dataset(root, num_images=num_images, seed=SET_SEED)
        create_csv_files(root / "images", root / "labels", root, SPLIT, image_ext=".jpg")
    return root


def folders(root: Path) -> dict:
    return {"image_folder": root / "images", "annotation_folder": root / "labels"}


def loader_seconds_per_batch(root: Path, tc: cfg.TrainConfig, recipe: Recipe) -> float:
    """Host seconds per train batch of the recipe's loader (decode or cache,
    mosaic, the C++ augmenter, collate), timed over a second pass: the first
    fills the image cache, as train()'s first epoch does."""
    from ..data.loader import get_loaders

    train_loader, _, _ = get_loaders(
        root, batch_size=tc.batch_size, anchors=recipe.anchors, num_workers=NUM_WORKERS,
        mosaic=tc.mosaic, cache_images=tc.cache_images, image_size=tc.image_size,
        strides=recipe.model_config().strides, **folders(root))
    sum(1 for _ in train_loader)
    t0 = time.perf_counter()
    n = sum(1 for _ in train_loader)
    return (time.perf_counter() - t0) / max(n, 1)


def metrics_rows(models: Path) -> list:
    path = models / f"YOLOv3_Turbine_Detection_{IDENTIFIER}_metrics.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []


def _finite(v: float):
    return v if np.isfinite(v) else str(v)


def run_recipe(recipe: Recipe, seed: int, root: Path, models: Path, device,
               report_callback=None, **overrides) -> dict:
    """``train()`` of ``recipe`` with ``TrainConfig.seed = seed`` on the set
    at ``root``, logs and checkpoint under ``models`` (emptied first). A stop
    on the NaN guard is a result (``nan_stop``), not an error."""
    from ..train.trainer import train

    tc = recipe.train_config(seed=seed, **overrides)
    shutil.rmtree(models, ignore_errors=True)
    loader_s = loader_seconds_per_batch(root, tc, recipe)
    nan_stop = False
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # the metrics logger prints each row
        try:
            train(tc, root, models, IDENTIFIER, early_stop=EARLY_STOP,
                  report_callback=report_callback, num_workers=NUM_WORKERS,
                  anchors=recipe.anchors, backbone=recipe.backbone, device=device,
                  **folders(root))
        except ValueError as e:
            if "Nan loss" not in str(e):
                raise
            nan_stop = True
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    rows = metrics_rows(models)
    maps = [r["mAP"] for r in rows if "mAP" in r]
    return {
        "recipe": recipe.name, "backbone": recipe.backbone, "seed": seed,
        "lr": tc.lr, "warmup": tc.warmup, "max_num_steps": tc.max_num_steps,
        "batch_size": tc.batch_size, "image_size": tc.image_size,
        "compute_dtype": tc.compute_dtype, "nan_stop": nan_stop,
        "best_map": max(maps, default=0.0), "jax_best_map": recipe.jax_best_map,
        "map_trajectory": maps,
        "train_loss_by_epoch": [_finite(r["train_loss"]) for r in rows if "train_loss" in r],
        "val_loss_by_epoch": [_finite(r["val_loss"]) for r in rows if "val_loss" in r],
        "steps": sum("lr" in r for r in rows), "wall_s": wall,
        "loader_s_per_batch": loader_s,
        "checkpoint": str(models / f"best_model_{IDENTIFIER}.ckpt"),
    }


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


def serve_checkpoint(ckpt, root: Path, recipe: Recipe, device, **overrides) -> dict:
    """The checkpoint of a run of ``recipe`` (with ``overrides`` of its
    TrainConfig) on the val split: the trainer's own fused eval of it
    (device mAP and host ``calc_map``), then served by
    ``load_predictor_from_checkpoint`` in bf16 and int8 (module
    docstring)."""
    from ..data.augment import test_transforms
    from ..data.dataset import YOLODataset
    from ..data.loader import get_loaders
    from ..inference import load_predictor_from_checkpoint
    from ..train.checkpoint import load_checkpoint
    from ..train.trainer import Trainer

    tc = recipe.train_config(**overrides)
    image_size = tc.image_size
    model_cfg = recipe.model_config()
    _, val_loader, _ = get_loaders(root, batch_size=tc.batch_size, anchors=recipe.anchors,
                                   num_workers=NUM_WORKERS, image_size=image_size,
                                   strides=model_cfg.strides, **folders(root))
    out = {"val_images": len(val_loader.dataset), "val_batches": len(val_loader)}

    class _Drop:
        def log(self, d):
            pass

    for name, device_eval in (("device", True), ("host", False)):
        trainer = Trainer(dataclasses.replace(tc, device_eval=device_eval), model_cfg,
                          anchors=recipe.anchors, device=device)
        load_checkpoint(trainer.state, ckpt)
        out[f"trainer_map_{name}"] = trainer.val_one_epoch(val_loader, 9, _Drop())[1]
        del trainer

    pred = load_predictor_from_checkpoint(ckpt, num_classes=model_cfg.num_classes,
                                          activation=model_cfg.activation,
                                          anchors=recipe.anchors, image_size=image_size,
                                          backbone=recipe.backbone,
                                          device=device)
    out["served_bf16"] = served_map(pred, val_loader, model_cfg.num_classes)
    out["heads_vs_f32"] = heads_vs_f32(pred, next(iter(val_loader))[0])
    calib_ds = YOLODataset(root / "train.csv", root / "images", root / "labels",
                           recipe.anchors, image_size=image_size,
                           grid_sizes=cfg.grid_sizes_for(image_size, model_cfg.strides),
                           num_classes=model_cfg.num_classes,
                           transform=test_transforms(image_size))
    calib = np.stack([calib_ds[i][0] for i in range(CALIB_IMAGES)])
    pred.quantize(calib)
    out["served_int8"] = served_map(pred, val_loader, model_cfg.num_classes)
    out["calib_images"] = CALIB_IMAGES
    out["served_bf16_minus_trainer"] = out["served_bf16"]["map"] - out["trainer_map_device"]
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


def child(args) -> None:
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    recipe = RECIPES[args.recipe]
    if args.backbone:
        recipe = dataclasses.replace(recipe, backbone=args.backbone)
    overrides = {k: v for k, v in (("batch_size", args.batch_size),
                                   ("max_num_steps", args.max_num_steps),
                                   ("image_size", args.image_size),
                                   ("compute_dtype", args.compute_dtype)) if v is not None}
    work = Path(args.work_dir)
    root = work / "data"
    models = work / f"models_{args.recipe}_s{args.seed}"
    try:
        r = run_recipe(recipe, args.seed, root, models, device, **overrides)
        ckpt = Path(r["checkpoint"])
        if args.serve and ckpt.exists():
            with contextlib.redirect_stdout(sys.stderr):
                r["serve"] = serve_checkpoint(ckpt, root, recipe, device, **overrides)
        print(json.dumps(r), flush=True)
    finally:
        shutil.rmtree(models, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--recipe", choices=sorted(RECIPES), default="R1")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--serve", action="store_true",
                    help="read each run's best checkpoint served, bf16 and int8")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work-dir", default=str(WORK_DIR))
    ap.add_argument("--num-images", type=int, default=None)
    ap.add_argument("--backbone", default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--max-num-steps", type=int, default=None)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--compute-dtype", choices=("bfloat16", "float32"), default=None)
    ap.add_argument("--seed", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.seed is not None:
        child(args)
        return 0
    torch.device(args.device)  # refuse a bad device name before any work
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("the recipes run on CUDA and no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    recipe = RECIPES[args.recipe]
    make_set(Path(args.work_dir) / "data", args.num_images or recipe.num_images)
    passed = [f"--{k.replace('_', '-')}={v}" for k, v in vars(args).items()
              if v is not None and k not in ("seeds", "serve", "seed")]
    passed += ["--serve"] * args.serve
    for seed in args.seeds:
        cmd = [sys.executable, "-m", "yolo_for_turbines_tpu_torch.tools.convergence",
               *passed, "--seed", str(seed)]
        done = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, check=True, cwd=REPO)
        print(done.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
