"""Torch port: the public functions of ported modules that the serving and
training slices did not need (``ops/nms.py::non_max_suppression``,
``ops/iou.py::iou_aligned``, ``models/yolov3.py::param_count``,
``config.py::Paths``, ``train/steps.py::warmup_schedule``,
``make_optimizer`` and ``make_forward_eval``,
``native/__init__.py::native_available``) and the package exports of
``ops`` and ``models``, against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optax

import yolo_for_turbines_tpu.models as jax_models
import yolo_for_turbines_tpu.ops as jax_ops
import yolo_for_turbines_tpu_torch.models as port_models
import yolo_for_turbines_tpu_torch.ops as port_ops
from helpers import MINI_LAYERS, mini_model
from torch_eval_weights import eval_weights
from yolo_for_turbines_tpu import native as jax_native
from yolo_for_turbines_tpu import config as jax_config
from yolo_for_turbines_tpu.ops.iou import iou_aligned as jax_iou_aligned
from yolo_for_turbines_tpu.ops.nms import non_max_suppression as jax_nms
from yolo_for_turbines_tpu.models.yolov3 import param_count as jax_param_count
from yolo_for_turbines_tpu.train import steps as jax_steps
from yolo_for_turbines_tpu_torch import native as port_native
from yolo_for_turbines_tpu_torch import config as port_config
from yolo_for_turbines_tpu_torch.models.convert import trainable_from_numpy, trainable_to_numpy
from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3, build_plan, param_count
from yolo_for_turbines_tpu_torch.ops.iou import iou_aligned
from yolo_for_turbines_tpu_torch.ops.nms import non_max_suppression
from yolo_for_turbines_tpu_torch.train import steps as port_steps


def _rows(seed, n, classes=3):
    """n boxes [x, y, w, h, score, class] with distinct scores."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.1, 0.7, (n, 2))
    wh = rng.uniform(0.05, 0.3, (n, 2))
    scores = rng.permutation(np.linspace(0.3, 0.99, n))
    cls = rng.integers(0, classes, n)
    return np.column_stack([xy, wh, scores, cls]).astype(np.float32).tolist()


@pytest.mark.parametrize("box_format", ["corners", "center"])
@pytest.mark.parametrize("seed,n", [(0, 1), (1, 12), (2, 60)])
def test_non_max_suppression_matches_jax(seed, n, box_format):
    boxes = _rows(seed, n)
    got = non_max_suppression(boxes, iou_threshold=0.45, obj_threshold=0.5,
                              box_format=box_format)
    want = jax_nms(boxes, iou_threshold=0.45, obj_threshold=0.5, box_format=box_format)
    assert len(got) == len(want)
    np.testing.assert_allclose(np.asarray(got, np.float32).reshape(-1, 6),
                               np.asarray(want, np.float32).reshape(-1, 6), rtol=0, atol=0)


def test_non_max_suppression_of_nothing():
    assert non_max_suppression([], 0.45, 0.5) == [] == jax_nms([], 0.45, 0.5)


def test_iou_aligned_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0.01, 1.0, (7, 1, 2)).astype(np.float32)
    b = rng.uniform(0.01, 1.0, (1, 9, 2)).astype(np.float32)
    got = iou_aligned(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jax_iou_aligned(jnp.asarray(a), jnp.asarray(b)))
    assert tuple(got.shape) == (7, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    same = iou_aligned([0.2, 0.4], [0.2, 0.4])
    assert float(same) == pytest.approx(1.0)


@pytest.mark.parametrize("layers", ["mini", "tiny"])
def test_param_count_matches_jax(layers):
    if layers == "mini":
        jax_model = mini_model()
        cfg = port_config.ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    else:
        from yolo_for_turbines_tpu.models.yolov3 import YOLOv3 as JaxYOLOv3

        jax_model = JaxYOLOv3(jax_config.ModelConfig(num_classes=2, backbone="yolov3_tiny",
                                                     strides=(32, 16)))
        cfg = port_config.ModelConfig(num_classes=2, backbone="yolov3_tiny", strides=(32, 16))
    params, _ = jax_model.init(jax.random.PRNGKey(0))
    port = YOLOv3(cfg, generator=torch.Generator().manual_seed(0))
    want = jax_param_count(params)
    assert param_count(port) == want
    assert param_count(trainable_to_numpy(port)[0]) == want


def test_paths_match_jax():
    for project in (".", "/srv/turbines"):
        jp, pp = jax_config.Paths(project), port_config.Paths(project)
        for name in ("image_folder", "annotation_folder", "weights_folder", "model_folder",
                     "csv_folder", "coco_weights", "darknet_weights"):
            assert getattr(pp, name) == getattr(jp, name), name
    assert port_config.Paths() == port_config.Paths(".")


def test_ops_exports_match_jax():
    names = {n for n in dir(jax_ops) if not n.startswith("_")
             and callable(getattr(jax_ops, n))}
    assert names and names <= set(dir(port_ops)), names - set(dir(port_ops))


def test_models_exports_match_jax():
    # the JAX package's functional init / apply are the port's module
    # constructors and forward
    names = {n for n in dir(jax_models) if not n.startswith("_")
             and not isinstance(getattr(jax_models, n), type(jax_models))} - {"init", "apply"}
    assert names <= set(dir(port_models)), names - set(dir(port_models))
    assert port_models.LAYER_CONFIG == jax_models.LAYER_CONFIG
    assert port_models.CSP_LAYER_CONFIG == jax_models.CSP_LAYER_CONFIG


# warmup_schedule against the optax schedule at every step, within 2.5e-7
# of the peak lr (two f32 spacings of it): optax computes init + (end -
# init) * frac in f32, the JAX step's own twin (scheduled_lr) as the port
# does; measured 1.3e-7 of the peak
_SCHEDULES = [
    dict(lr=1e-3, max_num_steps=550, warmup=0.05, decay_lr=True),
    dict(lr=5e-4, max_num_steps=700, warmup=0.1, decay_lr=True),
    dict(lr=1e-3, max_num_steps=200, warmup=0.01),
    dict(lr=2e-4, max_num_steps=20, warmup=0.5),
    dict(lr=1e-3, max_num_steps=50, warmup_enabled=False, decay_lr=True),
]


@pytest.mark.parametrize("kw", _SCHEDULES)
def test_warmup_schedule_matches_optax_at_every_step(kw):
    schedule = port_steps.warmup_schedule(port_config.TrainConfig(**kw))
    want_fn = jax_steps.warmup_schedule(jax_config.TrainConfig(**kw))
    n = kw["max_num_steps"] + 2
    got = np.array([schedule(i) for i in range(n)])
    want = np.array([float(want_fn(i)) for i in range(n)])
    np.testing.assert_allclose(got, want, rtol=0, atol=2.5e-7 * kw["lr"])


def _sgd_pair(frozen_names):
    """A small module, its parameters as a flat JAX tree (name -> array) and
    the frozen mask of ``frozen_names``."""
    torch.manual_seed(0)
    module = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4),
                                 torch.nn.Conv2d(4, 2, 1))
    tree = {n: p.detach().numpy().copy() for n, p in module.named_parameters()}
    mask = {n: n in frozen_names for n in tree}
    return module, tree, mask


@pytest.mark.parametrize("frozen", [(), ("0.weight", "1.bias")])
def test_make_optimizer_steps_as_the_jax_transformation(frozen):
    """Three updates from the same gradients, at the schedule's lr of each
    step: the port's SGD against the JAX tx scaled by that lr, as the JAX
    step applies it (measured 6e-8 relative)."""
    kw = dict(lr=1e-2, max_num_steps=10, warmup=0.2, decay_lr=True, momentum=0.9,
              weight_decay=5e-4)
    build, schedule = port_steps.make_optimizer(port_config.TrainConfig(**kw), frozen)
    module, tree, mask = _sgd_pair(frozen)
    opt = build(module)
    assert [n for n, p in module.named_parameters() if not p.requires_grad] == list(frozen)
    tx, jschedule = jax_steps.make_optimizer(jax_config.TrainConfig(**kw),
                                             mask if frozen else None)
    opt_state = jax_steps._set_injected_hyperparams(tx.init(tree), jax_config.TrainConfig(**kw))
    rng = np.random.default_rng(1)
    params = dict(module.named_parameters())
    for step in range(3):
        grads = {n: rng.normal(size=v.shape).astype(np.float32) for n, v in tree.items()}
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        for n, p in params.items():
            p.grad = None if n in frozen else torch.from_numpy(grads[n])
        opt.step()
        updates, opt_state = tx.update(grads, opt_state, tree)
        lr = float(jschedule(step))
        tree = optax.apply_updates(tree, jax.tree_util.tree_map(lambda u: u * lr, updates))
        for n, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(tree[n]), rtol=1e-6,
                                       atol=1e-9, err_msg=f"step {step} {n}")
    for n in frozen:
        assert n not in {id(p) for g in opt.param_groups for p in g["params"]}


def test_make_forward_eval_matches_jax():
    """Eval-mode raw heads of the mini model on calibrated weights. float32:
    within the trainable tests' 1e-4 relative RMS per head of JAX's
    (measured 6.5e-6). bf16 (autocast here, bf16 compute in JAX) is held to
    JAX's float32 heads: no further from them than JAX's own bf16 heads,
    with half again for room (measured 0.107 against JAX's 0.182)."""
    model, params, stats = eval_weights(seed=31, size=64)
    port = trainable_from_numpy(build_plan(model.cfg), params, stats, model.cfg, device="cpu")
    jstate = jax_steps.TrainState(params, stats, None, None, None)
    x = np.random.default_rng(32).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    heads = {}
    for dtype in ("float32", "bfloat16"):
        state = port_steps.create_train_state(port, port_config.TrainConfig(compute_dtype=dtype))
        heads["port", dtype] = [h.numpy() for h in port_steps.make_forward_eval(
            port_config.TrainConfig(compute_dtype=dtype))(state, torch.from_numpy(x))]
        heads["jax", dtype] = [np.asarray(h, np.float64) for h in jax_steps.make_forward_eval(
            model, jax_config.TrainConfig(compute_dtype=dtype))(jstate, jnp.asarray(x))]
        assert all(h.dtype == np.float32 for h in heads["port", dtype])
    assert port.training  # the module's mode is restored

    def dist(a, b):
        assert [h.shape for h in a] == [h.shape for h in b]
        return max(np.linalg.norm(g - w) / np.linalg.norm(w) for g, w in zip(a, b))

    want = heads["jax", "float32"]
    assert dist(heads["port", "float32"], want) <= 1e-4
    assert dist(heads["port", "bfloat16"], want) <= 1.5 * dist(heads["jax", "bfloat16"], want)


def test_native_available_matches_jax():
    assert port_native.native_available() == jax_native.native_available()
    assert port_native.native_available() == (port_native.load_library() is not None)
