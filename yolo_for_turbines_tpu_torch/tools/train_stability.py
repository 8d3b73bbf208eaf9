"""How close ``chip_smoke.py``'s from-scratch training runs sit to divergence,
at the lrs given.

    python -m yolo_for_turbines_tpu_torch.tools.train_stability --what train --lr 1e-3 2e-4 [--processes 4]
    python -m yolo_for_turbines_tpu_torch.tools.train_stability --what steps --backbone cspdarknet53 --lr 5e-4 1e-4

``--what train`` runs the smoke's ``train()``: the 2-class Darknet-53 with
mish from its seeded init, 96 seeded synthetic JPEGs split 85 / 15, B = 32,
20 steps of which 10 warm the lr up, 2 per epoch. ``--what steps`` runs the
smoke's 20 bf16 Trainer steps on one fixed seeded batch of B = 32 at
``--size``, no warmup, after ``prewarm``. Each of ``--processes`` fresh
processes runs every lr once (cuDNN picks its algorithms per process, so
the runs of one process differ less than those of two), and prints one
JSON line per run: the loss per epoch (train) or per step (steps), and
whether the trainer's NaN guard stopped it. A last line sums up each lr:
the runs, the NaN stops and the largest loss after the first epoch or
the first 5 steps. Needs a CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SEED = 0
WORK_DIR = Path(__file__).resolve().parents[2] / "_smoke" / "stability"


def run_train(lr: float, device, work: Path) -> dict:
    """The smoke's train() at peak ``lr``: losses per epoch."""
    from .. import config as cfg
    from ..data.splits import create_csv_files
    from ..data.synthetic import generate_synthetic_dataset
    from ..train.trainer import train

    root = work / "data"
    if not root.exists():
        generate_synthetic_dataset(root, num_images=96, seed=SEED)
        create_csv_files(root / "images", root / "labels", root, {"train": 0.85, "val": 0.15},
                         image_ext=".jpg")
    models = work / "models"
    shutil.rmtree(models, ignore_errors=True)
    tc = cfg.TrainConfig(batch_size=32, max_num_steps=20, warmup=0.5, lr=lr)
    stopped = False
    with contextlib.redirect_stdout(sys.stderr):  # the metrics logger prints
        try:
            train(tc, root, models, "stability", early_stop=5, device=device,
                  image_folder=root / "images", annotation_folder=root / "labels")
        except ValueError:
            stopped = True
    rows = [json.loads(line) for line in open(models / "YOLOv3_Turbine_Detection_stability_metrics.jsonl")]
    return {"nan_stop": stopped,
            "losses": [r["train_loss"] for r in rows if "train_loss" in r],
            "val_losses": [r["val_loss"] for r in rows if "val_loss" in r]}


def run_steps(lr: float, device, backbone: str, size: int) -> dict:
    """The smoke's 20 fixed-batch bf16 steps at ``lr``: losses per step."""
    from .. import config as cfg
    from ..train.trainer import Trainer
    from .profile_serving import train_batch

    model_cfg = cfg.ModelConfig(num_classes=cfg.NUM_TURBINE_CLASSES, activation="mish",
                                backbone=backbone, strides=cfg.strides_for(backbone))
    trainer = Trainer(cfg.TrainConfig(batch_size=32, warmup_enabled=False, lr=lr), model_cfg,
                      device=device)
    trainer.prewarm(sizes=(size,))
    # the smoke's seeds: Darknet-53's batch SEED + 9, CSP's SEED + 22
    x, targets = train_batch(32, size, device, seed=SEED + (9 if backbone == "darknet53" else 22))
    anchors = trainer._anchors(size)
    losses = [trainer.train_step(trainer.state, x, targets, anchors)["loss"] for _ in range(20)]
    return {"nan_stop": False, "losses": torch.stack(losses).tolist()}


def child(args) -> None:
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(args.work_dir) / f"p{args.process}"
    try:
        for lr in args.lr:
            if args.what == "train":
                r = run_train(lr, device, work)
            else:
                r = run_steps(lr, device, args.backbone, args.size)
            print(json.dumps({"process": args.process, "what": args.what, "lr": lr, **r}),
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def summarize(rows, what: str) -> dict:
    skip = 1 if what == "train" else 5
    out = {}
    for r in rows:
        s = out.setdefault(str(r["lr"]), {"runs": 0, "nan_stops": 0, "max_loss_after_start": []})
        s["runs"] += 1
        s["nan_stops"] += int(r["nan_stop"])
        later = np.asarray(r["losses"][skip:], np.float64)
        s["max_loss_after_start"].append(float(np.max(later)) if later.size else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", choices=("train", "steps"), default="train")
    ap.add_argument("--lr", type=float, nargs="+", default=[2e-4])
    ap.add_argument("--backbone", default="darknet53", help="--what steps: the model")
    ap.add_argument("--size", type=int, default=416, help="--what steps: the image size")
    ap.add_argument("--processes", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work-dir", default=str(WORK_DIR))
    ap.add_argument("--process", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.process is not None:
        child(args)
        return 0
    rows = []
    for p in range(args.processes):
        cmd = [sys.executable, "-m", "yolo_for_turbines_tpu_torch.tools.train_stability",
               "--what", args.what, "--lr", *map(str, args.lr), "--backbone", args.backbone,
               "--size", str(args.size), "--device", args.device, "--work-dir", args.work_dir,
               "--process", str(p)]
        done = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, check=True,
                              cwd=Path(__file__).resolve().parents[2])
        for line in done.stdout.splitlines():
            print(line, flush=True)
            rows.append(json.loads(line))
    print(json.dumps({"what": args.what, "backbone": args.backbone if args.what == "steps" else
                      "darknet53", "summary": summarize(rows, args.what)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
