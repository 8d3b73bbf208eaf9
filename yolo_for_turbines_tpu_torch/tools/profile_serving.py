"""Where the device time of ``Predictor.predict_batch`` (or of the fused
eval step, or of a train step) goes (``torch.profiler``).

    python -m yolo_for_turbines_tpu_torch.tools.profile_serving [--batch N] [--eval | --train] [--out FILE]

builds the 80-class Darknet-53 YOLOv3 at 416px from seeded random weights
(as ``chip_smoke.py`` does), profiles ``predict_batch`` in bf16, then
quantizes it (int8 PTQ, calibrated on 8 seeded images) and profiles the int8
path. With ``--eval`` it profiles instead the fused eval step
(``train/evaluate.py::make_fused_eval_step``) of the trainable module from
its seeded init, in bf16 autocast, on seeded noise images with empty target
grids. With ``--train`` it profiles one train step
(``train/steps.py::make_train_step``: forward, loss, backward and SGD
update) of the 2-class Darknet-53 with mish, as ``train()`` builds it, in
bf16 autocast at 416px, on seeded noise images with one box each. The
batch is 128 for serving and eval and 32 for a train step unless
``--batch`` says otherwise. Per path it prints one JSON line (wall ms per
batch, device-busy ms per batch, the device's idle share) and the kernels
with the most device time; ``--out`` also gets ``torch.profiler``'s full
table. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def profile_predict_batch(pred, x, **kwargs):
    """:func:`profile_calls` of ``pred.predict_batch(x)``."""
    return profile_calls(lambda: pred.predict_batch(x), torch.device(pred.device), **kwargs)


def profile_calls(call, device, iters: int = 2, warmup: int = 3, top: int = 12):
    """Profile ``iters`` calls of ``call()`` on ``device`` after ``warmup``.

    Returns (summary, table): summary has ``wall_ms`` and ``device_busy_ms``
    per call (the device-side events' time; 0 on the CPU), ``idle_share``
    = 1 - busy / wall, and ``top``, the kernels and copies with the most
    device time per call as [name, ms, launches per call]; table is the
    profiler's own."""
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for _ in range(warmup):
        call()
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    ka = prof.key_averages()
    # device-side events only: an aten op also carries its kernels' time
    kernels = [e for e in ka if e.device_type != DeviceType.CPU]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    rows = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    summary = {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "top": [[e.key, e.self_device_time_total / 1e3 / iters, e.count // iters]
                for e in rows if e.self_device_time_total > 0],
    }
    table = ka.table(sort_by="self_device_time_total" if cuda else "self_cpu_time_total",
                     row_limit=25, max_name_column_width=70)
    return summary, table


def profile_eval_step(model, x, targets, **kwargs):
    """:func:`profile_calls` of the fused eval step (bf16 autocast) of the
    trainable ``model`` on ``(x, targets)``."""
    from ..config import ANCHORS
    from ..train.evaluate import make_fused_eval_step

    step = make_fused_eval_step(model)
    return profile_calls(lambda: step(x, targets, ANCHORS), x.device, **kwargs)


def profile_train_step(trainer, x, targets, **kwargs):
    """:func:`profile_calls` of the Trainer's train step (its config's
    compute dtype) on ``(x, targets)``; each call updates a copy of the
    trainer's state, which is left as it was."""
    import copy

    state = copy.deepcopy(trainer.state)
    anchors = trainer._anchors(x.shape[1])
    return profile_calls(lambda: trainer.train_step(state, x, targets, anchors), x.device,
                         **kwargs)


def train_batch(batch: int, size: int, device, strides=(32, 16, 8), classes: int = 2,
                seed: int = 0, anchors=None):
    """Seeded noise images and their targets (one random box per image,
    ``assign_targets`` over ``anchors``, ``TURBINE_ANCHORS`` by default:
    one row of anchors per stride), on ``device``."""
    from ..config import TURBINE_ANCHORS, grid_sizes_for
    from ..data.dataset import assign_targets

    rng = np.random.default_rng(seed)
    anchors = np.asarray(TURBINE_ANCHORS if anchors is None else anchors,
                         np.float32).reshape(-1, 2)
    x = rng.uniform(size=(batch, size, size, 3)).astype(np.float32)
    per_image = [assign_targets([[*rng.uniform(0.2, 0.8, 2), *rng.uniform(0.05, 0.5, 2),
                                  int(rng.integers(classes))]], anchors,
                                grid_sizes_for(size, strides)) for _ in range(batch)]
    targets = tuple(torch.from_numpy(np.stack([t[i] for t in per_image])).to(device)
                    for i in range(len(strides)))
    return torch.from_numpy(x).to(device), targets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--eval", action="store_true",
                      help="profile the fused eval step of the trainable module instead")
    mode.add_argument("--train", action="store_true",
                      help="profile one bf16 train step of the 2-class mish model instead")
    ap.add_argument("--mesh", action="store_true",
                    help="with --train: the data-parallel step at world size 1 over NCCL "
                         "(synced BN, global loss counts, gradient all-reduce)")
    ap.add_argument("--out", default=None, help="also write the profiler tables here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")

    from ..config import ModelConfig
    from ..inference import Predictor
    from ..models.yolov3 import build_plan, init_plan

    dev = torch.device("cuda", 0)
    batch = args.batch or (32 if args.train else 128)
    if args.train:
        from ..config import TrainConfig
        from ..train.trainer import Trainer

        trainer = Trainer(TrainConfig(batch_size=batch, warmup_enabled=False), device=dev)
        x, targets = train_batch(batch, 416, dev)
        path = "train_bf16"
        if args.mesh:
            import socket

            import torch.distributed as dist

            from ..parallel.mesh import create_mesh
            from ..train.steps import make_train_step

            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                                    world_size=1)
            trainer.train_step = make_train_step(trainer.cfg, create_mesh(device=dev))
            path = "train_bf16_mesh_world1"
        try:
            summary, table = profile_train_step(trainer, x, targets)
        finally:
            if args.mesh:
                dist.destroy_process_group()
        print(json.dumps({"path": path, "batch": batch, **summary}), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(f"== {path}, bf16 autocast, B={batch}\n{table}")
        return 0
    model_cfg = ModelConfig()  # 80 classes, Darknet-53, leaky
    if args.eval:
        from ..config import grid_sizes_for
        from ..models.yolov3 import YOLOv3

        model = YOLOv3(model_cfg, generator=torch.Generator().manual_seed(0)).to(
            dev, memory_format=torch.channels_last)
        x = torch.from_numpy(np.random.default_rng(0).uniform(
            size=(batch, 416, 416, 3)).astype(np.float32)).to(dev)
        targets = [torch.zeros(batch, model_cfg.anchors_per_scale, s, s, 6, device=dev)
                   for s in grid_sizes_for(416, model_cfg.strides)]
        summary, table = profile_eval_step(model, x, targets)
        print(json.dumps({"path": "eval_bf16", "batch": batch, **summary}), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(f"== eval step, bf16 autocast, B={batch}\n{table}")
        return 0
    tree = init_plan(build_plan(model_cfg), torch.Generator().manual_seed(0))
    pred = Predictor.from_folded(model_cfg, tree, device=dev)
    size = pred.image_size
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(batch, size, size, 3)).astype(np.float32)).to(dev)
    calib = np.random.default_rng(1).uniform(size=(8, size, size, 3)).astype(np.float32)
    tables = []
    for path in ("bf16", "int8"):
        if path == "int8":
            pred.quantize(calib)
        summary, table = profile_predict_batch(pred, x)
        print(json.dumps({"path": path, "batch": batch, **summary}), flush=True)
        tables.append(f"== {path}, B={batch}\n{table}")
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(tables))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
