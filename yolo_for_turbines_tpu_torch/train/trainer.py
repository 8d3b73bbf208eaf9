"""Training orchestration: epoch loops, multi-scale buckets, early stop,
checkpoints, metrics (counterpart of ``yolo_for_turbines_tpu/train/trainer.py``;
reference: code/train.py:34-239).

Control-flow parity with the reference's ``train()``:
- model = YOLOv3(turbine classes, configured activation), darknet53.conv.74
  backbone import with optional freeze (reference: code/train.py:166-169),
- SGD(lr, momentum, weight_decay) + linear warmup from 1e-6*lr
  (reference: code/train.py:171-189),
- dataset scale change every ``num_batch_to_resize`` batches
  (reference: code/train.py:45-46),
- val every epoch; accuracy + mAP every 10th epoch, in one fused pass whose
  NMS launches K1 on CUDA; best-mAP tracking with early-stop countdown
  (reference: code/train.py:199-227),
- checkpoints at every 25% of epochs and at the end
  (reference: code/train.py:229-237).

Documented divergence (kept from the JAX package): the reference computes
``scaled_anchors`` once from the 416 grid sizes (code/train.py:195-197);
here anchors are scaled by the actual batch's grid size, consistent with
the target encoding.

``Trainer``, ``train()`` and the ASHA adapter ``HPOTrainFn`` run on
``device``, ``"cuda"`` unless the caller asks for the CPU; with no CUDA
device they raise.

Parallel training (``parallel/``): ``Trainer(mesh=)`` takes a mesh of
ranks, every rank building the trainer. Rank 0's initial weights are
broadcast; each global batch is loaded whole on every rank (the per-item
augmentation RNG is spawned in call order, so a loader of the rank's rows
alone would draw other augmentations) and the rank's shard of it is placed
on its device (``shard_batch``, or ``shard_spatial_batch`` on a ``("data",
"space")`` mesh); the train step is the global batch's
(``train/steps.py``). A multi-scale ``change_scale()`` draws the same
sizes on every rank (one seed, one call per ``num_batch_to_resize``
batches); which batch a new size reaches first follows the loader's lead,
so under DP two ranks may serve one step at two sizes, which the step's
count-weighted BN moments and loss means take as one mixed global batch.
Under SP the ranks of one image must agree on its size, so a spatial mesh
refuses ``multi_scale``. Eval runs unsharded on every rank, as in the JAX
trainer; its mAP and loss are rank 0's on every rank, so that every rank
takes the same early-stop decisions. Only rank 0 writes logs and
checkpoints.

Under ``torchrun`` ``train()`` joins the process group and builds the mesh
itself (``parallel/mesh.py::init_from_env``), as the JAX trainer's data
parallelism is automatic. The JAX trainer uses the largest divisor of
``batch_size`` that fits its devices and leaves the rest idle; a rank of a
``torchrun`` job cannot idle through it, so when that divisor is not the
world's size, ``train()`` raises and names it.
"""

from __future__ import annotations

import copy
import hashlib
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import config as cfg
from ..config import ModelConfig, TrainConfig
from ..data.loader import get_loaders, prefetch_to_device
from ..models.darknet_weights import load_darknet_into
from ..models.yolov3 import YOLOv3, refuse_walk_only
from ..ops.map import calc_map, calc_map_device_batched
from ..parallel import comm
from ..parallel.mesh import batch_sharding, create_mesh, init_from_env
from ..parallel.spatial import is_spatial, spatial_image_sharding, spatial_target_sharding
from ..utils.device import resolve_device
from .checkpoint import load_checkpoint, save_checkpoint
from .evaluate import evaluate_map, make_fused_eval_step, rows_from_eval_step
from .metrics import MetricsLogger
from .steps import (
    compute_dtype_of,
    create_train_state,
    make_eval_step,
    make_train_step,
    scheduled_lr,
)


def scaled_anchors_for(anchors, image_size: int, strides=cfg.STRIDES) -> np.ndarray:
    gs = np.asarray(cfg.grid_sizes_for(image_size, strides), np.float32)
    return np.asarray(anchors, np.float32) * gs[:, None, None]


def _sum(tots, metrics):
    """Device-side running sums of metric dicts."""
    return dict(metrics) if tots is None else {k: tots[k] + v for k, v in metrics.items()}


def _to_host(tots) -> dict:
    """Metric sums as floats, in one device-to-host copy."""
    if not tots:
        return {}
    keys = list(tots)
    return dict(zip(keys, torch.stack([tots[k].float() for k in keys]).tolist()))


def _check_mesh(mesh, train_cfg: TrainConfig) -> None:
    from ..parallel.mesh import DATA_AXIS

    if not mesh.active:
        raise ValueError(f"rank {mesh.rank} is idle on this mesh of {mesh.size} ranks")
    spatial = is_spatial(mesh)
    ways = mesh.axis_size(DATA_AXIS) if spatial else mesh.size
    if train_cfg.batch_size % ways:
        raise ValueError(f"batch_size {train_cfg.batch_size} does not divide over the "
                         f"{ways} ranks that hold its rows")
    if spatial and train_cfg.multi_scale and mesh.size > 1:
        raise ValueError("multi_scale under spatial partitioning: the ranks of one image "
                         "must agree on its size, which the loader's lead does not ensure")


def data_parallel_mesh(batch_size: int, device="cuda"):
    """The ``("data",)`` mesh of a ``torchrun`` job for ``batch_size``: the
    largest divisor of the batch that fits the world must be the world's
    size, since a rank cannot sit a job out."""
    world = torch.distributed.get_world_size()
    n = max(d for d in range(1, world + 1) if batch_size % d == 0)
    if n != world:
        raise ValueError(
            f"batch_size {batch_size} does not divide over the {world} ranks of this job; "
            f"the largest divisor that fits is {n}: launch {n} ranks "
            f"(torchrun --nproc_per_node={n}) or a batch size that {world} divides")
    return create_mesh(device=device)


class _NullLogger:
    """The logger of a rank other than 0: it writes nothing."""

    def log(self, metrics) -> None:
        pass

    def log_model(self, path, name: str) -> None:
        pass

    def finish(self) -> None:
        pass


class Trainer:
    def __init__(
        self,
        train_cfg: TrainConfig,
        model_cfg: Optional[ModelConfig] = None,
        anchors=cfg.TURBINE_ANCHORS,
        weights_path=None,
        device=None,
        report_callback=None,
        mesh=None,
    ):
        """``device`` is ``"cuda"`` when not given; with a ``mesh`` it is
        the mesh's device (module docstring)."""
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
            _check_mesh(mesh, train_cfg)
        self.device = resolve_device("cuda" if device is None else device, "training")
        self.mesh = mesh
        # rank 0 logs, checkpoints and reports
        self.is_main = mesh is None or mesh.rank == 0
        self.cfg = train_cfg
        self.model_cfg = model_cfg or ModelConfig(
            num_classes=cfg.NUM_TURBINE_CLASSES, activation=train_cfg.activation
        )
        self.anchors = np.asarray(anchors, np.float32)
        self.report_callback = report_callback
        self.compute_dtype = compute_dtype_of(train_cfg.compute_dtype)

        model = YOLOv3(self.model_cfg,
                       generator=torch.Generator().manual_seed(train_cfg.seed))
        refuse_walk_only(model.plan, "the Trainer",
                         "its training recipe (its loss and target assignment) is not ported; "
                         "such a plan serves only")
        frozen = []
        if weights_path is not None and train_cfg.load_weights:
            frozen, _ = load_darknet_into(str(weights_path), model,
                                          freeze=train_cfg.freeze_backbone)
        if self.device.type == "cuda":
            # every bucket is a new conv shape: let cuDNN time its algorithms
            # once per shape (prewarm does that before the first epoch)
            torch.backends.cudnn.benchmark = True
            model = model.to(self.device, memory_format=torch.channels_last)
        else:
            model = model.to(self.device)
        self.model = model
        self.state = create_train_state(model, train_cfg, frozen)
        step_mesh = None
        if mesh is not None:
            comm.broadcast_module(model, mesh.group)  # replicas start from rank 0's
            step_mesh = mesh if mesh.size > 1 else None
        self.train_step = make_train_step(train_cfg, step_mesh)
        # eval runs unsharded: val batches may be ragged (no drop_last)
        self.eval_step = make_eval_step(train_cfg)

    def _shard(self, batch):
        """This rank's host shard of a global (images, targets) batch."""
        images, targets = batch
        if self.mesh is None:
            return images, targets
        if is_spatial(self.mesh):
            img, tgt = spatial_image_sharding(self.mesh), spatial_target_sharding(self.mesh)
        else:
            img = tgt = batch_sharding(self.mesh)
        return img.take(images), tuple(tgt.take(t) for t in targets)

    def _from_rank0(self, value: float) -> float:
        """``value`` as rank 0 has it, on every rank of the mesh."""
        if self.mesh is None:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        return float(comm.broadcast_(t, self.mesh.group)[0])

    # ------------------------------------------------------------------

    def _anchors(self, image_size: int) -> torch.Tensor:
        return torch.from_numpy(
            scaled_anchors_for(self.anchors, image_size, self.model.strides)).to(self.device)

    def prewarm(self, sizes=None):
        """One train step per multi-scale bucket (MULTI_SCALE_TRAIN_SIZES)
        on a throwaway copy of the module and optimizer, so that cuDNN's
        algorithm choices and the allocator's pools are made before the
        first epoch; the trained state is untouched."""
        if sizes is None:
            sizes = (
                cfg.MULTI_SCALE_TRAIN_SIZES
                if self.cfg.multi_scale
                else (self.cfg.image_size,)
            )
        state = copy.deepcopy(self.state)  # module and optimizer together
        b = self.cfg.batch_size
        a = self.model_cfg.anchors_per_scale
        for size in sizes:
            images, targets = self._shard((
                np.zeros((b, size, size, 3), np.float32),
                tuple(np.zeros((b, a, size // s, size // s, 6), np.float32)
                      for s in self.model.strides)))
            images, targets = self._batch(images, targets)
            self.train_step(state, images, targets, self._anchors(size))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_one_epoch(self, train_ds, train_loader, logger):
        # double-buffered device placement: batch N+1's host-to-device copy
        # overlaps batch N's step
        batches = prefetch_to_device(train_loader, self.device, size=2, sharding=self._shard)
        # metrics accumulate ON THE DEVICE: a per-step float() would sync
        # host and device every step; only the epoch-end read does
        dev_tots = None
        n = 0
        start_step = self.state.step
        for batch_idx, (x, y) in enumerate(batches):
            if (
                self.cfg.multi_scale
                and (batch_idx + 1) % self.cfg.num_batch_to_resize == 0
            ):
                train_ds.change_scale()  # next batches re-bucket
            # the width: under SP this rank holds a band of the rows
            metrics = self.train_step(self.state, x, y, self._anchors(x.shape[2]))
            dev_tots = _sum(dev_tots, metrics)
            n += 1
            if start_step + n >= self.cfg.max_num_steps:
                break
        batches.close()
        # per-step lr series logged in one pass (reference logs per step,
        # code/train.py:73)
        for i in range(n):
            logger.log({"lr": scheduled_lr(start_step + i, self.state.hyper)})
        tots = _to_host(dev_tots)
        if not np.isfinite(tots.get("loss", 0.0)):
            raise ValueError("Nan loss")
        avg = {f"train_{k}": v / max(n, 1) for k, v in tots.items()}
        logger.log(avg)
        return avg.get("train_loss", 0.0)

    def _batch(self, x, y):
        x = torch.as_tensor(x).to(self.device)
        return x, tuple(torch.as_tensor(t).to(self.device) for t in y)

    def val_one_epoch(self, val_loader, epoch, logger):
        if (epoch + 1) % 10 != 0:
            # plain epochs: loss-only pass, metrics summed on the device and
            # read once at epoch end
            dev_tots = None
            n = 0
            for x, y in val_loader:
                x, y = self._batch(x, y)
                metrics = self.eval_step(self.state, x, y, self._anchors(x.shape[1]))
                dev_tots = _sum(dev_tots, metrics)
                n += 1
            avg = {f"val_{k}": v / max(n, 1) for k, v in _to_host(dev_tots).items()}
            logger.log(avg)
            return self._from_rank0(avg.get("val_loss", 0.0)), None

        # every-10th-epoch eval: ONE fused pass over the val set. The forward
        # runs once per batch and feeds the loss, the accuracy counts and
        # decode / NMS (K1 on CUDA) / mAP together, in the trainer's compute
        # dtype
        step = make_fused_eval_step(self.model, cfg.CONF_THRESHOLD, self.compute_dtype)
        dev_tots = None
        dev_counts = None
        n = 0
        # device-eval accumulators (tensors stay on the device until the
        # final scalar mAP) vs host-eval row lists (calc_map)
        pred_rows, pred_ok, true_rows, true_ok = [], [], [], []
        host_preds, host_trues = [], []
        data_idx = 0
        for x, y in val_loader:
            x, y = self._batch(x, y)
            metrics, counts, kept, mask, true = step(x, y, self.anchors)
            dev_tots = _sum(dev_tots, metrics)
            dev_counts = counts if dev_counts is None else dev_counts + counts
            n += 1
            if self.cfg.device_eval:
                pred_rows.append(kept)
                pred_ok.append(mask)
                true_rows.append(true)
                true_ok.append(true[..., 4] > cfg.CONF_THRESHOLD)
            else:
                p, t, data_idx = rows_from_eval_step(
                    kept, mask, true, data_idx, cfg.CONF_THRESHOLD
                )
                host_preds.extend(p)
                host_trues.extend(t)

        avg = {f"val_{k}": v / max(n, 1) for k, v in _to_host(dev_tots).items()}
        logger.log(avg)

        counts = dev_counts.cpu().numpy() if dev_counts is not None else np.zeros(6)
        class_acc = float(counts[0] / (counts[1] + 1e-16))
        obj_acc = float(counts[2] / (counts[3] + 1e-16))
        noobj_acc = float(counts[4] / (counts[5] + 1e-16))

        if self.cfg.device_eval:
            mAP = float(
                calc_map_device_batched(
                    torch.cat(pred_rows),
                    torch.cat(pred_ok),
                    torch.cat(true_rows),
                    torch.cat(true_ok),
                    iou_threshold=cfg.MAP_IOU_THRESHOLD,
                    num_classes=self.model_cfg.num_classes,
                )
            )
        else:
            mAP = calc_map(
                host_preds,
                host_trues,
                iou_threshold=cfg.MAP_IOU_THRESHOLD,
                box_format="center",
                num_classes=self.model_cfg.num_classes,
            )
        logger.log(
            {
                "class_accuracy": class_acc,
                "noobj_accuracy": noobj_acc,
                "obj_accuracy": obj_acc,
                "mAP": mAP,
            }
        )
        mAP = self._from_rank0(mAP)
        if self.report_callback is not None and self.is_main:
            self.report_callback({"mAP": mAP})
        return self._from_rank0(avg.get("val_loss", 0.0)), mAP


def _train_config(config) -> TrainConfig:
    """A TrainConfig from a config mapping (its TrainConfig keys) or as is."""
    if isinstance(config, TrainConfig):
        return config
    return TrainConfig(**{k: v for k, v in config.items() if k in TrainConfig.__dataclass_fields__})


class HPOTrainFn:
    """Picklable adapter for the ASHA driver (``train/hpo.py::tune_model``).

    Calling trains ``num_epochs`` *additional* epochs and evaluates mAP at
    the end of the budget (``evaluate_map``: K1 once per val batch on the
    card), carrying ``(trainer, loaders, logger, epoch)`` across rungs so
    promoted trials resume instead of restarting (reference
    code/train.py:153,252-270). Picklability is what lets
    ``tune_model(max_concurrent>1)`` ship it to spawned trial workers; the
    resume state then lives inside each worker process. Trials run on
    ``device`` (``"cuda"`` unless the caller asks for the CPU; it raises
    without a card).
    """

    def __init__(
        self,
        csv_folder_path,
        model_folder_path,
        image_folder=None,
        annotation_folder=None,
        anchors=cfg.TURBINE_ANCHORS,
        weights_path=None,
        num_workers: int = 8,
        device="cuda",
    ):
        self.csv_folder_path = csv_folder_path
        self.model_folder_path = model_folder_path
        self.image_folder = image_folder
        self.annotation_folder = annotation_folder
        self.anchors = np.asarray(anchors, np.float32)
        self.weights_path = weights_path
        self.num_workers = num_workers
        self.device = str(resolve_device(device, "HPOTrainFn"))

    def __call__(self, config, num_epochs, resume_state):
        if resume_state is None:
            tc = _train_config(config)
            trainer = Trainer(tc, anchors=self.anchors, weights_path=self.weights_path,
                              device=self.device)
            loaders = get_loaders(
                self.csv_folder_path,
                batch_size=tc.batch_size,
                anchors=self.anchors,
                train=True,
                image_folder=self.image_folder,
                annotation_folder=self.annotation_folder,
                num_workers=self.num_workers,
                mosaic=tc.mosaic,
                cache_images=tc.cache_images,
                image_size=tc.image_size,
                strides=trainer.model.strides,
            )
            cfg_repr = str(sorted(config.items()) if isinstance(config, dict) else config)
            # stable across processes (unlike hash(), which is salted by
            # PYTHONHASHSEED) so trial logs keep one name under HPO resume
            trial_id = hashlib.sha1(cfg_repr.encode()).hexdigest()[:8]
            logger = MetricsLogger(f"hpo_trial_{trial_id}", out_dir=self.model_folder_path)
            epoch = 0
        else:
            trainer, loaders, logger, epoch = resume_state
        train_loader, val_loader, train_ds = loaders

        for _ in range(num_epochs):
            trainer.train_one_epoch(train_ds, train_loader, logger)
            epoch += 1
        mAP = evaluate_map(val_loader, trainer.model, trainer.anchors,
                           num_classes=trainer.model_cfg.num_classes,
                           compute_dtype=trainer.compute_dtype)
        logger.log({"mAP": mAP, "epoch": epoch})
        return mAP, (trainer, loaders, logger, epoch)


def make_hpo_train_fn(
    csv_folder_path,
    model_folder_path,
    image_folder=None,
    annotation_folder=None,
    anchors=cfg.TURBINE_ANCHORS,
    weights_path=None,
    num_workers: int = 8,
    device="cuda",
):
    """Build the picklable HPOTrainFn adapter (see HPOTrainFn). mAP is
    evaluated once per ASHA rung boundary: the rung budget is the eval
    cadence, as in the reference's session.report flow."""
    return HPOTrainFn(
        csv_folder_path,
        model_folder_path,
        image_folder=image_folder,
        annotation_folder=annotation_folder,
        anchors=anchors,
        weights_path=weights_path,
        num_workers=num_workers,
        device=device,
    )


def train(
    hyperparam_config,
    csv_folder_path,
    model_folder_path,
    identifier: str,
    early_stop: int,
    checkpoint_name: Optional[str] = None,
    image_folder=None,
    annotation_folder=None,
    anchors=cfg.TURBINE_ANCHORS,
    weights_path=None,
    report_callback=None,
    num_workers: int = 8,
    backbone: str = "darknet53",
    num_classes: int = cfg.NUM_TURBINE_CLASSES,
    device="cuda",
    mesh=None,
) -> float:
    """Reference-parity train() entry (code/train.py:158-239). Returns best
    mAP. Under ``torchrun`` it joins the process group and trains on the
    job's ``data_parallel_mesh`` (on ``cuda:<LOCAL_RANK>``) unless ``mesh``
    is given; the group it joined is left before it returns."""
    tc = _train_config(hyperparam_config)
    joined = False
    if mesh is None and not torch.distributed.is_initialized():
        joined = init_from_env(device)
        if joined:
            mesh = data_parallel_mesh(tc.batch_size, device)
    try:
        return _train(tc, csv_folder_path, model_folder_path, identifier,
                      early_stop, checkpoint_name, image_folder, annotation_folder, anchors,
                      weights_path, report_callback, num_workers, backbone, num_classes,
                      device, mesh)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(tc, csv_folder_path, model_folder_path, identifier, early_stop,
           checkpoint_name, image_folder, annotation_folder, anchors, weights_path,
           report_callback, num_workers, backbone, num_classes, device, mesh) -> float:
    if mesh is not None:
        device = mesh.device
    device = resolve_device(device, "training")
    main = mesh is None or mesh.rank == 0
    # the anchors belong in the run config (the reference logs its whole
    # hyperparam dict, code/train.py:164): a custom-anchor run must be
    # auditable from the metrics file alone
    run_config = json.loads(tc.to_json())
    run_config["anchors"] = np.asarray(anchors, np.float32).tolist()
    run_config["backbone"] = backbone
    logger = MetricsLogger(
        f"YOLOv3_Turbine_Detection_{identifier}",
        config=run_config,
        out_dir=model_folder_path,
    ) if main else _NullLogger()
    trainer = Trainer(
        tc,
        model_cfg=ModelConfig(
            num_classes=num_classes,
            activation=tc.activation,
            backbone=backbone,
            strides=cfg.strides_for(backbone),
        ),
        anchors=anchors,
        weights_path=weights_path,
        device=None if mesh is not None else device,
        report_callback=report_callback,
        mesh=mesh,
    )
    if tc.load_checkpoint and checkpoint_name:
        load_checkpoint(trainer.state, Path(model_folder_path) / checkpoint_name, tc.lr)

    train_loader, val_loader, train_ds = get_loaders(
        csv_folder_path,
        batch_size=tc.batch_size,
        anchors=anchors,
        train=True,
        image_folder=image_folder,
        annotation_folder=annotation_folder,
        num_workers=num_workers,
        mosaic=tc.mosaic,
        cache_images=tc.cache_images,
        image_size=tc.image_size,
        strides=trainer.model.strides,
    )

    best_map = 0.0
    # a host copy: the live state keeps training
    best_state = trainer.state.snapshot()
    epoch = 0
    num_epochs = max(1, tc.max_num_steps // max(len(train_loader), 1))
    early_stop_limit = early_stop
    start = time.time()
    ckpt_path = Path(model_folder_path) / f"best_model_{identifier}.ckpt"

    # the step cap also gates the epoch loop: a resumed state starts at its
    # checkpointed step
    while (
        epoch < num_epochs
        and early_stop > 0
        and trainer.state.step < tc.max_num_steps
    ):
        trainer.train_one_epoch(train_ds, train_loader, logger)
        val_loss, mAP = trainer.val_one_epoch(val_loader, epoch, logger)
        if mAP is not None:
            if mAP > best_map:
                best_map, best_state = mAP, trainer.state.snapshot()
                early_stop = early_stop_limit
            elif mAP < best_map:
                early_stop -= 1
        epoch += 1
        if main and num_epochs >= 4 and (epoch + 1) % max(1, int(0.25 * num_epochs)) == 0:
            save_checkpoint(best_state, ckpt_path)
            logger.log_model(ckpt_path, f"best_model_{identifier}")
        logger.log({"time_elapsed_in_hours": (time.time() - start) / 3600})

    if main:
        save_checkpoint(best_state, ckpt_path)
        logger.log_model(ckpt_path, f"best_model_{identifier}")
    logger.finish()
    return best_map
