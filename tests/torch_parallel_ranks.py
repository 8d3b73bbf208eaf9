"""What the spawned gloo ranks of tests/test_torch_parallel.py and
tests/test_torch_spatial.py run (``torch_dist.run_ranks``): the port's
parallel paths on the CPU, on inputs the test process made with numpy and
the JAX package. This module imports neither jax nor the JAX package, so a
rank starts with torch alone; each function returns numpy results for the
test process to hold against its references.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from helpers import MINI_LAYERS
from yolo_for_turbines_tpu_torch.config import ModelConfig, TrainConfig
from yolo_for_turbines_tpu_torch.inference import Predictor
from yolo_for_turbines_tpu_torch.models.convert import trainable_from_numpy, trainable_to_numpy
from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan
from yolo_for_turbines_tpu_torch.parallel.mesh import (
    create_mesh,
    create_multislice_mesh,
    shard_batch,
)
from yolo_for_turbines_tpu_torch.parallel.spatial import (
    Layout,
    create_spatial_mesh,
    shard_spatial_batch,
    spatial_image_sharding,
)
from yolo_for_turbines_tpu_torch.train.steps import create_train_state, make_train_step

CPU = "cpu"


def mini_cfg(**kw) -> ModelConfig:
    return ModelConfig(num_classes=2, layer_config=MINI_LAYERS, **kw)


def tiny_cfg() -> ModelConfig:
    return ModelConfig(num_classes=2, backbone="yolov3_tiny", strides=(32, 16))


def train_cfg(**kw) -> TrainConfig:
    base = dict(lr=1e-3, max_num_steps=10, compute_dtype="float32")
    base.update(kw)
    return TrainConfig(**base)


def params_vector(model) -> np.ndarray:
    return np.concatenate([p.detach().double().ravel().numpy() for p in model.parameters()])


def initial_vector(case) -> np.ndarray:
    model_cfg = case["model_cfg"]
    return params_vector(trainable_from_numpy(build_plan(model_cfg), case["params"],
                                              case["stats"], model_cfg, device=CPU))


def one_step(case, mesh=None, shard=shard_batch, dtype=torch.float32):
    """One train step of the port (``compute_dtype="float32"``: no
    autocast) from ``case``'s JAX trees, its module and images in
    ``dtype``: on this rank's shard with ``mesh``, on the whole batch
    without. Returns the loss terms and the new (params, batch_stats)
    trees (float32), or with float64 the new parameters as one vector."""
    model_cfg = case["model_cfg"]
    model = trainable_from_numpy(build_plan(model_cfg), case["params"], case["stats"],
                                 model_cfg, device=CPU).to(dtype)
    state = create_train_state(model, train_cfg())
    images, targets = case["images"].astype(torch.empty((), dtype=dtype).numpy().dtype), \
        tuple(case["targets"])
    if mesh is None:
        x, y = torch.from_numpy(images), tuple(map(torch.from_numpy, targets))
    elif shard is shard_batch:
        x, y = shard_batch((images, targets), mesh)
    else:
        x, y = shard(images, targets, mesh)
    metrics = make_train_step(train_cfg(), mesh)(state, x, y, torch.from_numpy(case["anchors"]))
    metrics = {k: float(v) for k, v in metrics.items()}
    if dtype == torch.float64:
        return metrics, params_vector(model)
    return metrics, trainable_to_numpy(model)


def _fingerprint(tree) -> float:
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif t is not None:
            leaves.append(np.asarray(t, np.float64).ravel())

    walk(tree)
    v = np.concatenate(leaves)
    return float(v @ np.arange(1, v.size + 1, dtype=np.float64) % 1e6)


def _tensors(tree):
    """A qparams tree with its tensors as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def step_result(case, mesh, shard=shard_batch):
    """The f32 step (the JAX tests' gates) and the float64 step (held to
    the single-process float64 step, where f32 rounding cannot hide a
    wrong gradient) on this rank."""
    metrics, (params, stats) = one_step(case, mesh, shard)
    # every rank returns its replica's fingerprint; rank 0 the trees
    out = {"metrics": metrics, "fingerprint": _fingerprint((params, stats))}
    if mesh.rank == 0:
        out["params"], out["stats"] = params, stats
        out["f64"] = one_step(case, mesh, shard, torch.float64)[1]
    else:
        one_step(case, mesh, shard, torch.float64)
    return out


# ---------------------------------------------------------------------------
# Data parallelism
# ---------------------------------------------------------------------------


def broadcast_after_routed_call(rank, case):
    """A one-scale model whose 16x16x512 stage is routed to K2's plain
    version on the CPU. Each rank starts from its own weights; the mesh
    predictor serves rank 0's. After a routed call (the stage's copies made)
    rank 0 doubles a 1x1 weight and ``sync_replicas`` broadcasts it: every
    rank must then serve the doubled weights."""
    from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy

    cfg, plan = case["one_scale_cfg"], case["one_scale_plan"]
    model = folded_from_numpy(plan, case["one_scale_trees"][rank], cfg)
    mesh = create_mesh(device=CPU)
    pred = Predictor(model, mesh=mesh, anchors=case["one_scale_anchors"], image_size=32,
                     max_boxes=16)
    first = pred.predict_batch(case["one_scale_x"])
    stage = pred.model.layers[1]
    assert stage._stacked is not None, "the stage was not routed"
    weight = stage.blocks[0]["conv1"].weight
    if rank == 0:
        with torch.no_grad():
            weight.mul_(2.0)
    version = weight._version
    pred.sync_replicas()
    out = {"first": [t.numpy() for t in first],
           "version_kept": weight._version == version,
           "second": [t.numpy() for t in pred.predict_batch(case["one_scale_x"])]}
    return out


def dp_two(rank, world, case):
    """The 2-rank group of tests/test_torch_parallel.py."""
    mesh = create_mesh(device=CPU)
    out = {"mesh": (mesh.axis_names, mesh.shape, mesh.rank, str(mesh.device))}
    out["darknet"] = step_result(case["darknet"], mesh)
    out["tiny"] = step_result(case["tiny"], mesh)
    pred = Predictor.from_folded(mini_cfg(), case["folded"], mesh=mesh, image_size=64,
                                 max_boxes=64, compute_dtype=torch.float32)
    kept, mask = pred.predict_batch(case["serve_x"])
    out["predictor"] = (kept.numpy(), mask.numpy())
    try:
        pred.predict_batch(case["serve_x"][:3])
        out["ragged_refused"] = False
    except ValueError as e:
        out["ragged_refused"] = "pad_batch_to_multiple" in str(e)
    out["broadcast"] = broadcast_after_routed_call(rank, case)
    out["trainer"] = dp_trainer(mesh, case["trainer"])
    return out


def dp_four(rank, world, case):
    """The 4-rank group of tests/test_torch_parallel.py: DP over 4 ranks and
    over a 2x2 ("dcn", "data") mesh."""
    mesh = create_mesh(device=CPU)
    out = {"darknet": step_result(case, mesh)}
    ms = create_multislice_mesh(2, 2, device=CPU)
    out["multislice_axes"] = (ms.axis_names, ms.shape, ms.axis_index("dcn"),
                              ms.axis_index("data"))
    out["multislice"] = step_result(case, ms)
    return out


class _ListLoader:
    """Replays the batches the test process made: both trainers see the
    same data."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


class _Sink:
    def log(self, d):
        pass


def dp_trainer(mesh, case):
    """A mesh Trainer against the single-process one on the same batches
    (tests/test_parallel.py::test_trainer_dp_end_to_end): two one-step
    epochs, then an every-10th-epoch val epoch."""
    from yolo_for_turbines_tpu_torch.train.trainer import Trainer

    tc = TrainConfig(**case["train_cfg"])
    t1 = Trainer(tc, model_cfg=mini_cfg(), device=CPU)
    tn = Trainer(tc, model_cfg=mini_cfg(), mesh=mesh)
    same_init = bool(np.array_equal(params_vector(t1.model), params_vector(tn.model)))
    batches = case["batches"]
    loss1 = t1.train_one_epoch(None, _ListLoader(batches[:1]), _Sink())
    lossn = tn.train_one_epoch(None, _ListLoader(batches[:1]), _Sink())
    t1.train_one_epoch(None, _ListLoader(batches[1:2]), _Sink())
    tn.train_one_epoch(None, _ListLoader(batches[1:2]), _Sink())
    v1, vn = params_vector(t1.model), params_vector(tn.model)
    val = _ListLoader(case["val_batches"])
    vloss1, map1 = t1.val_one_epoch(val, epoch=9, logger=_Sink())
    vlossn, mapn = tn.val_one_epoch(val, epoch=9, logger=_Sink())
    return {"same_init": same_init, "loss1": loss1, "lossn": lossn,
            "cos": float(v1 @ vn / (np.linalg.norm(v1) * np.linalg.norm(vn))),
            "rel": float(np.linalg.norm(v1 - vn) / np.linalg.norm(v1)),
            "vloss1": vloss1, "vlossn": vlossn, "map1": map1, "mapn": mapn,
            "fingerprint": float(vn @ np.arange(1, vn.size + 1) % 1e6)}


# ---------------------------------------------------------------------------
# Spatial partitioning
# ---------------------------------------------------------------------------


def sp_four(rank, world, case):
    """The 4-rank group of tests/test_torch_spatial.py, on a 2x2 ("data",
    "space") mesh."""
    out = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sub = create_spatial_mesh(n_space=2, n_data=1, device=CPU)
    out["idle"] = ([str(w.message) for w in caught], sub.shape, sub.active)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        full = create_spatial_mesh(device=CPU)
    out["default"] = (full.shape, len(caught))
    try:
        create_spatial_mesh(n_space=4, n_data=2, device=CPU)
        out["too_big_refused"] = False
    except ValueError:
        out["too_big_refused"] = True
    mesh = create_spatial_mesh(n_space=2, n_data=2, device=CPU)
    out["coords"] = (mesh.axis_index("data"), mesh.axis_index("space"))

    # the folded forward on this rank's rows
    model = Predictor.from_folded(mini_cfg(), case["folded"], device=CPU,
                                  compute_dtype=torch.float32).model
    x = spatial_image_sharding(mesh).place(case["forward_x"])
    with torch.inference_mode():
        heads = model(x, layout=Layout(mesh))
    out["forward"] = [h.numpy() for h in heads]

    pred = Predictor.from_folded(mini_cfg(), case["folded"], mesh=mesh, image_size=64,
                                 max_boxes=64, compute_dtype=torch.float32)
    out["predictor_kernels_off"] = pred.model.fuse_resblocks is False
    kept, mask = pred.predict_batch(case["serve_x"])
    out["predictor"] = (kept.numpy(), mask.numpy())
    # the int8 path on the same mesh, on rank 0's calibration
    pred.quantize(case["serve_x"] if mesh.rank == 0 else case["serve_x"][::-1].copy())
    kept, mask = pred.predict_batch(case["serve_x"])
    out["int8_qparams"] = _fingerprint(_tensors(pred._qparams))
    out["int8_predictor"] = (kept.numpy(), mask.numpy())
    out["int8_heads"] = [h.numpy() for h in pred.raw_heads(case["serve_x"])]
    if mesh.rank == 0:
        out["int8_tree"] = _tensors(pred._qparams)

    out["step"] = step_result(case["step"], mesh, shard_spatial_batch)
    out["trainer"] = sp_trainer(mesh, case["trainer"])
    return out


def sp_trainer(mesh, case):
    """A spatial-mesh Trainer against the single-process one over one epoch
    (tests/test_spatial.py::test_trainer_spatial_epoch_matches_single_device)."""
    from yolo_for_turbines_tpu_torch.train.trainer import Trainer

    tc = TrainConfig(**case["train_cfg"])
    t1 = Trainer(tc, model_cfg=mini_cfg(), device=CPU)
    tsp = Trainer(tc, model_cfg=mini_cfg(), mesh=mesh)
    loss1 = t1.train_one_epoch(None, _ListLoader(case["batches"]), _Sink())
    loss2 = tsp.train_one_epoch(None, _ListLoader(case["batches"]), _Sink())
    p1 = [p.detach().numpy().copy() for p in t1.model.parameters()]
    p2 = [p.detach().numpy().copy() for p in tsp.model.parameters()]
    out = {"loss1": loss1, "loss2": loss2,
           "fingerprint": _fingerprint(p2)}
    if mesh.rank == 0:
        out["p1"], out["p2"] = p1, p2
    return out

