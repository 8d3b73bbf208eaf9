"""Torch port: the eval stack (``train/evaluate.py``) against the JAX
package over three batches.

The mini model (tests/helpers.py) at 64px, 2 classes, B=2, float32 on the
CPU, on calibrated weights (``torch_eval_weights.py``): every layer carries
signal and the objectness logits spread around 0, so scores are far apart
next to the frameworks' differences and the 0.5 threshold flips no count.
Half of each image's ground truth is the model's own NMS survivors, so the
mAP is neither 0 nor 1. Loss terms within 1e-5 relative, counts equal,
survivors as row sets sorted by score (the frameworks' top-k orders ties
differently) within 1e-4 relative or 1e-5 absolute, as the heads they come
from (test_torch_trainable.py); ground truth rows equal; mAP within 1e-5.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_eval_weights import eval_weights
from yolo_for_turbines_tpu.train import evaluate as jeval
from yolo_for_turbines_tpu_torch import config as cfg
from yolo_for_turbines_tpu_torch.data.dataset import assign_targets
from yolo_for_turbines_tpu_torch.models.convert import trainable_from_numpy
from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan
from yolo_for_turbines_tpu_torch.train import evaluate as teval

SIZE, BATCH, CLASSES, K, G = 64, 2, 2, 64, 16
TOL = 1e-5
BOX_RTOL = 1e-4


def _sorted_rows(rows):
    rows = np.asarray(rows, np.float64).reshape(-1, np.shape(rows)[-1] if len(rows) else 7)
    return rows[np.lexsort((rows[:, 1], -rows[:, -2]))]


@pytest.fixture(scope="module")
def setup():
    model, params, stats = eval_weights(seed=11, size=SIZE, num_classes=CLASSES)
    port = trainable_from_numpy(build_plan(model.cfg), params, stats, model.cfg, device="cpu")
    rng = np.random.default_rng(12)
    grids = cfg.grid_sizes_for(SIZE)
    anchors9 = cfg.anchors_array(cfg.ANCHORS).reshape(-1, 2)
    boxes_step = teval.make_eval_boxes_step(port, torch.float32, max_boxes=8)
    loader = []
    for _ in range(3):
        images = rng.uniform(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
        kept, mask, _ = boxes_step(images, np.zeros((BATCH, 3, grids[-1], grids[-1], 6),
                                                    np.float32), cfg.ANCHORS)
        per_image = []
        for b in range(BATCH):
            own = [[*np.clip(r[:2], 0, 0.999), *np.clip(r[2:4], 0.02, 0.9), r[5]]
                   for r in kept[b][mask[b]].numpy()[:3]]
            rand = [[*rng.uniform(0.05, 0.95, 2), *rng.uniform(0.05, 0.6, 2),
                     int(rng.integers(CLASSES))] for _ in range(int(rng.integers(1, 4)))]
            per_image.append(assign_targets(own + rand, anchors9, grids))
        loader.append((images, [np.stack([t[i] for t in per_image]) for i in range(3)]))
    state = types.SimpleNamespace(params=params, batch_stats=stats)
    return model, state, port, loader


@pytest.fixture(scope="module")
def fused(setup):
    model, state, port, loader = setup
    jstep = jeval.make_fused_eval_step(model, compute_dtype=jnp.float32, max_boxes=K, max_gt=G)
    tstep = teval.make_fused_eval_step(port, compute_dtype=torch.float32, max_boxes=K, max_gt=G)
    out = []
    for images, targets in loader:
        want = jstep(state.params, state.batch_stats, jnp.asarray(images),
                     tuple(jnp.asarray(t) for t in targets), np.asarray(cfg.ANCHORS, np.float32),
                     image_size=SIZE)
        out.append((tstep(images, targets, cfg.ANCHORS), want))
    return out


@pytest.mark.parametrize("batch", range(3))
def test_fused_eval_step_metrics_and_counts(fused, batch):
    (metrics, counts, _, _, _), (jmetrics, jcounts, _, _, _) = fused[batch]
    assert metrics.keys() == jmetrics.keys() == {"box_loss", "obj_loss", "no_obj_loss",
                                                 "class_loss", "loss"}
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=TOL, err_msg=k)
    assert counts.dtype == torch.float32 and counts.shape == (6,)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts[1] > 0 and 0 < counts[4] < counts[5]


@pytest.mark.parametrize("batch", range(3))
def test_fused_eval_step_survivors_and_ground_truth(fused, batch):
    (_, _, kept, mask, true), (_, _, jkept, jmask, jtrue) = fused[batch]
    assert kept.shape == (BATCH, K, 6) and mask.shape == (BATCH, K) and true.shape == (BATCH, G, 6)
    jkept, jmask, jtrue = np.asarray(jkept), np.asarray(jmask), np.asarray(jtrue)
    for b in range(BATCH):
        got, want = kept[b][mask[b]].numpy(), jkept[b][jmask[b]]
        assert 0 < len(got) == len(want)
        np.testing.assert_allclose(_sorted_rows(got), _sorted_rows(want), rtol=BOX_RTOL,
                                   atol=TOL)
        t, jt = true[b].numpy(), jtrue[b]
        got_gt, want_gt = t[t[:, 4] > 0.5], jt[jt[:, 4] > 0.5]
        assert len(got_gt) > 0
        np.testing.assert_array_equal(_sorted_rows(got_gt), _sorted_rows(want_gt))


def test_check_model_accuracy_matches_jax(setup):
    model, state, port, loader = setup
    got = teval.check_model_accuracy(loader, port, compute_dtype=torch.float32)
    want = jeval.check_model_accuracy(loader, model, state, compute_dtype=jnp.float32)
    assert got == want
    assert all(0 < v < 1 for v in got)


def test_get_eval_boxes_matches_jax(setup):
    model, state, port, loader = setup
    preds, trues = teval.get_eval_boxes(loader, port, cfg.ANCHORS, max_boxes=K,
                                        compute_dtype=torch.float32)
    jpreds, jtrues = jeval.get_eval_boxes(loader, model, state, cfg.ANCHORS, max_boxes=K,
                                          compute_dtype=jnp.float32)
    assert len(preds) == len(jpreds) > 0 and len(trues) == len(jtrues) > 0
    for img in range(3 * BATCH):
        np.testing.assert_allclose(_sorted_rows([r for r in preds if r[0] == img]),
                                   _sorted_rows([r for r in jpreds if r[0] == img]),
                                   rtol=BOX_RTOL, atol=TOL)
    np.testing.assert_array_equal(_sorted_rows(trues), _sorted_rows(jtrues))


def test_evaluate_map_matches_jax(setup):
    model, state, port, loader = setup
    got = teval.evaluate_map(loader, port, cfg.ANCHORS, CLASSES, compute_dtype=torch.float32)
    want = jeval.evaluate_map(loader, model, state, cfg.ANCHORS, CLASSES,
                              compute_dtype=jnp.float32)
    assert got == pytest.approx(want, abs=TOL)
    assert 0.0 < got < 1.0


def test_evaluate_map_device_matches_jax_and_host(setup):
    model, state, port, loader = setup
    got = teval.evaluate_map_device(loader, port, cfg.ANCHORS, CLASSES,
                                    compute_dtype=torch.float32)
    want = jeval.evaluate_map_device(loader, model, state, cfg.ANCHORS, CLASSES,
                                     compute_dtype=jnp.float32)
    host = teval.evaluate_map(loader, port, cfg.ANCHORS, CLASSES, compute_dtype=torch.float32)
    assert isinstance(got, float)
    assert got == pytest.approx(want, abs=TOL)
    assert got == pytest.approx(host, abs=TOL)


def test_eval_leaves_the_module_mode_and_statistics(setup):
    _, _, port, loader = setup
    port.train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    teval.check_model_accuracy(loader[:1], port, compute_dtype=torch.float32)
    assert port.training
    assert all(torch.equal(before[k], v) for k, v in port.state_dict().items())
    port.eval()


def test_bf16_autocast_step_is_finite(setup):
    _, _, port, loader = setup
    images, targets = loader[0]
    metrics, counts, kept, mask, _ = teval.make_fused_eval_step(port, max_boxes=K)(
        images, targets, cfg.ANCHORS)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert bool(torch.isfinite(kept).all()) and mask.dtype == torch.bool
    assert float(counts.sum()) > 0
