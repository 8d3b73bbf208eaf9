"""Torch port: one SGD train step and one eval step of the CSPDarknet-53 and
YOLOv3-tiny families against the JAX package's ``train/steps.py``, and the
port's ``train()`` end to end on tiny.

The mini CSP model and tiny with 2 classes at 64px, B = 2, float32 on the
CPU, as tests/test_torch_train_steps.py runs the mini Darknet-53: calibrated
weights whose running statistics are taken again, without jitter, on the
step's own images (the JAX train-mode moments are shifted by the running
mean); warmup off; the port's step starts from the JAX state. Tiny has two
scales (``TINY_ANCHORS``, targets on the 2x2 and 4x4 grids); the JAX step
runs unsharded (``make_train_step(model, tx, cfg)``: the JAX ``Trainer``
gives its jit three target shardings, which a two-scale model refuses).

Gates (those of tests/test_torch_train_steps.py, but 5e-3 for the CSP
leaves), each beside what was measured with it below (this CPU):
loss terms 1e-4 relative; each parameter leaf's update (new - old) and
momentum buffer, relative RMS, 1e-3 for tiny and 5e-3 for CSP; running
statistics 1e-4 per leaf. The mini CSP model turns a 1e-6 relative change of its input into
2e-4 at its heads (tests/test_torch_families.py), and its gradients follow.

``train()`` on tiny is held to itself: finite losses, the every-10th-epoch
eval, and a checkpoint that comes back bit for bit.
"""

import copy
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers import MINI_CSP_LAYERS
from torch_eval_weights import eval_weights
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu.config import ModelConfig as JaxModelConfig
from yolo_for_turbines_tpu.config import TrainConfig as JaxTrainConfig
from yolo_for_turbines_tpu.models import yolov3 as jyolo
from yolo_for_turbines_tpu.train import steps as jsteps
from yolo_for_turbines_tpu_torch import config as cfg
from yolo_for_turbines_tpu_torch.data.dataset import assign_targets
from yolo_for_turbines_tpu_torch.models.convert import trainable_from_numpy, trainable_to_numpy
from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan
from yolo_for_turbines_tpu_torch.train import steps

SIZE, BATCH, LR = 64, 2, 1e-3
FAMILIES = {
    "csp": (dict(num_classes=2, layer_config=MINI_CSP_LAYERS), cfg.ANCHORS),
    "tiny": (dict(num_classes=2, backbone="yolov3_tiny", strides=(32, 16)), cfg.TINY_ANCHORS),
}
# loss terms, relative: measured 1.6e-5 / 6.0e-6 (CSP train / eval step),
# 4.6e-6 / 8.4e-7 (tiny)
LOSS_RTOL = 1e-4
# per-leaf relative RMS of updates and momentum buffers: measured 1.19e-3
# (CSP), 1.9e-4 and 1.9e-5 (tiny)
LEAF_RTOL = {"csp": 5e-3, "tiny": 1e-3}
# running statistics, per leaf, relative RMS: measured 5.2e-6 (CSP), 3.5e-7
# (tiny)
STATS_RTOL = 1e-4


def _cfg(**kw):
    base = dict(lr=LR, batch_size=BATCH, max_num_steps=100, warmup_enabled=False,
                compute_dtype="float32")
    base.update(kw)
    return cfg.TrainConfig(**base), JaxTrainConfig(**base)


def _scaled(family):
    _, anchors = FAMILIES[family]
    strides = FAMILIES[family][0].get("strides", cfg.STRIDES)
    gs = np.asarray(cfg.grid_sizes_for(SIZE, strides), np.float32)
    return np.asarray(anchors, np.float32) * gs[:, None, None]


def _batch(family, seed):
    """Seeded images and targets (assign_targets on the family's scales)."""
    kw, anchors = FAMILIES[family]
    grids = cfg.grid_sizes_for(SIZE, kw.get("strides", cfg.STRIDES))
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
    per_image = []
    for _ in range(BATCH):
        boxes = [[*rng.uniform(0.1, 0.9, 2), *rng.uniform(0.05, 0.6, 2), int(rng.integers(2))]
                 for _ in range(int(rng.integers(1, 5)))]
        per_image.append(assign_targets(boxes, np.asarray(anchors, np.float32).reshape(-1, 2),
                                        grids))
    return x, tuple(np.stack([t[i] for t in per_image]) for i in range(len(grids)))


def _port(model, params, stats):
    return trainable_from_numpy(build_plan(model.cfg), params, stats, model.cfg, device="cpu")


@pytest.fixture(scope="module", params=list(FAMILIES))
def weights(request):
    """Calibrated weights with running statistics on the step's images."""
    family = request.param
    model = jyolo.YOLOv3(JaxModelConfig(activation="mish", **FAMILIES[family][0]))
    model, params, stats = eval_weights(seed=11, size=SIZE, model=model)
    port = _port(model, params, stats)
    bns = [m for m in port.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for bn in bns:
            bn.reset_running_stats()
            bn.momentum = None  # the cumulative average of one batch is that batch
        port.train()(torch.from_numpy(_batch(family, 12)[0]))
    params, stats = trainable_to_numpy(port)
    return family, model, params, stats


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.array(v, np.float64)) for p, v in flat]


def _rel_rms(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _worst(got_tree, want_tree):
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert [p for p, _ in got] == [p for p, _ in want] and got
    return max(_rel_rms(g, w) for (_, g), (_, w) in zip(got, want))


def _sub(a, b):
    return jax.tree_util.tree_map(
        lambda x, y: np.asarray(x, np.float64) - np.asarray(y, np.float64), a, b)


def _copy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def test_train_step_matches_jax(weights):
    family, model, params, stats = weights
    tcfg, jcfg = _cfg()
    x, y = _batch(family, 12)
    # JAX: one unsharded step; copies, since the donating step may reuse
    # numpy memory
    jstate, tx, _ = jsteps.create_train_state(model, jcfg, params=_copy(params),
                                              batch_stats=_copy(stats))
    jstate, jmetrics = jsteps.make_train_step(model, tx, jcfg)(
        jstate, jnp.asarray(x), tuple(map(jnp.asarray, y)), jnp.asarray(_scaled(family)))
    want_params, want_stats = _copy(jstate.params), _copy(jstate.batch_stats)
    want_trace = _copy(optax.tree_utils.tree_get(jstate.opt_state, "trace"))

    port = _port(model, params, stats)
    state = steps.create_train_state(port, tcfg)
    metrics = steps.make_train_step(tcfg)(state, torch.from_numpy(x),
                                          tuple(map(torch.from_numpy, y)),
                                          torch.from_numpy(_scaled(family)))
    got_params, got_stats = trainable_to_numpy(port)
    twin = copy.deepcopy(port)
    with torch.no_grad():
        for p, q in zip(port.parameters(), twin.parameters()):
            q.copy_(state.optimizer.state[p]["momentum_buffer"])
    got_trace = trainable_to_numpy(twin)[0]

    assert set(metrics) == {"loss", "box_loss", "obj_loss", "no_obj_loss", "class_loss"}
    for k, w in jmetrics.items():
        assert math.isfinite(float(w))
        assert abs(float(metrics[k]) - float(w)) <= LOSS_RTOL * abs(float(w)), k
    for _, u in _leaves(_sub(got_params, params)):
        assert np.abs(u).max() > 0
    assert _worst(_sub(got_params, params), _sub(want_params, params)) <= LEAF_RTOL[family]
    assert _worst(got_trace, want_trace) <= LEAF_RTOL[family]
    assert _worst(got_stats, want_stats) <= STATS_RTOL


def test_eval_step_matches_jax_and_mutates_nothing(weights):
    family, model, params, stats = weights
    tcfg, jcfg = _cfg()
    x, y = _batch(family, 14)
    jstate, _, _ = jsteps.create_train_state(model, jcfg, params=params, batch_stats=stats)
    want = jsteps.make_eval_step(model, jcfg)(jstate, jnp.asarray(x), tuple(map(jnp.asarray, y)),
                                              jnp.asarray(_scaled(family)))
    port = _port(model, params, stats).train()
    state = steps.create_train_state(port, tcfg)
    before = copy.deepcopy(port.state_dict())
    got = steps.make_eval_step(tcfg)(state, torch.from_numpy(x), tuple(map(torch.from_numpy, y)),
                                     torch.from_numpy(_scaled(family)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= LOSS_RTOL * abs(float(v)), k
    assert all(torch.equal(before[k], v) for k, v in port.state_dict().items())
    assert port.training and all(p.grad is None for p in port.parameters())


def test_tiny_train_end_to_end(tmp_path):
    """``train(backbone="yolov3_tiny")`` on the CPU: two-scale targets from
    the loader, 10 epochs with the fused eval at epoch 9, finite losses, the
    checkpoint back bit for bit and served by
    ``load_predictor_from_checkpoint``."""
    from yolo_for_turbines_tpu_torch.data.splits import create_csv_files
    from yolo_for_turbines_tpu_torch.data.synthetic import generate_synthetic_dataset
    from yolo_for_turbines_tpu_torch.inference import load_predictor_from_checkpoint
    from yolo_for_turbines_tpu_torch.train import trainer
    from yolo_for_turbines_tpu_torch.train.checkpoint import load_checkpoint

    root = generate_synthetic_dataset(tmp_path / "syn", num_images=6, image_size=(96, 72), seed=3)
    create_csv_files(root / "images", root / "labels", root, {"train": 0.5, "val": 0.5},
                     image_ext=".jpg")
    tc = cfg.TrainConfig(batch_size=2, max_num_steps=10, multi_scale=False, image_size=SIZE,
                         warmup=0.5, compute_dtype="float32")
    maps = []
    best = trainer.train(tc, root, tmp_path / "out", "tiny", early_stop=5, num_workers=1,
                         image_folder=root / "images", annotation_folder=root / "labels",
                         anchors=cfg.TINY_ANCHORS, backbone="yolov3_tiny",
                         report_callback=maps.append, device="cpu")
    assert 0.0 <= best <= 1.0 and len(maps) == 1
    rows = [json.loads(line) for line in
            open(tmp_path / "out" / "YOLOv3_Turbine_Detection_tiny_metrics.jsonl")]
    train_losses = [r["train_loss"] for r in rows if "train_loss" in r]
    assert len(train_losses) == 10 and all(math.isfinite(v) for v in train_losses)
    assert sum("mAP" in r for r in rows) == 1

    ckpt = tmp_path / "out" / "best_model_tiny.ckpt"
    want = torch.load(ckpt, weights_only=True)
    fresh = trainer.Trainer(tc, cfg.ModelConfig(num_classes=2, activation=tc.activation,
                                                backbone="yolov3_tiny", strides=(32, 16)),
                            anchors=cfg.TINY_ANCHORS, device="cpu")
    got = load_checkpoint(fresh.state, ckpt).snapshot()
    assert got["step"] == want["step"] and got["model"].keys() == want["model"].keys()
    assert all(torch.equal(got["model"][k], v) for k, v in want["model"].items())
    pred = load_predictor_from_checkpoint(ckpt, backbone="yolov3_tiny", anchors=cfg.TINY_ANCHORS,
                                          image_size=SIZE, device="cpu")
    kept, mask = pred.predict_batch(np.zeros((1, SIZE, SIZE, 3), np.float32))
    assert tuple(kept.shape) == (1, 3 * (2 ** 2 + 4 ** 2), 6) and bool(torch.isfinite(kept).all())
