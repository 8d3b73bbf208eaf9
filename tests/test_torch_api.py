"""Torch port: the public functions of ported modules that the serving and
training slices did not need (``ops/nms.py::non_max_suppression``,
``ops/iou.py::iou_aligned``, ``models/yolov3.py::param_count``,
``config.py::Paths``) and the package exports of ``ops`` and ``models``,
against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_for_turbines_tpu.models as jax_models
import yolo_for_turbines_tpu.ops as jax_ops
import yolo_for_turbines_tpu_torch.models as port_models
import yolo_for_turbines_tpu_torch.ops as port_ops
from helpers import MINI_LAYERS, mini_model
from yolo_for_turbines_tpu import config as jax_config
from yolo_for_turbines_tpu.ops.iou import iou_aligned as jax_iou_aligned
from yolo_for_turbines_tpu.ops.nms import non_max_suppression as jax_nms
from yolo_for_turbines_tpu.models.yolov3 import param_count as jax_param_count
from yolo_for_turbines_tpu_torch import config as port_config
from yolo_for_turbines_tpu_torch.models.convert import trainable_to_numpy
from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3, param_count
from yolo_for_turbines_tpu_torch.ops.iou import iou_aligned
from yolo_for_turbines_tpu_torch.ops.nms import non_max_suppression


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
