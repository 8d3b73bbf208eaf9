"""Torch port: the 4-term YOLOv3 loss against the JAX package.

Seeded raw heads and target grids encoded by ``assign_targets`` (objects,
background and ignore cells) go through ``train/loss.py`` of both packages
on the CPU in float32; every term within 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_for_turbines_tpu.train import loss as jloss
from yolo_for_turbines_tpu_torch import config as cfg
from yolo_for_turbines_tpu_torch.data.dataset import assign_targets
from yolo_for_turbines_tpu_torch.train import loss as tloss

RTOL = 1e-6
SIZE, CLASSES, BATCH = 64, 3, 3


def _batch(seed):
    rng = np.random.default_rng(seed)
    grids = cfg.grid_sizes_for(SIZE)
    anchors = cfg.anchors_array(cfg.ANCHORS).reshape(-1, 2)
    per_image = []
    for _ in range(BATCH):
        boxes = [[*rng.uniform(0.05, 0.95, 2), *rng.uniform(0.02, 0.9, 2),
                  int(rng.integers(CLASSES))] for _ in range(int(rng.integers(1, 9)))]
        per_image.append(assign_targets(boxes, anchors, grids))
    targets = [np.stack([t[i] for t in per_image]) for i in range(3)]
    preds = [rng.normal(0, 1.5, (BATCH, 3, s, s, 5 + CLASSES)).astype(np.float32)
             for s in grids]
    return preds, targets, cfg.scaled_anchors_array(cfg.ANCHORS, SIZE)


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_yolo_loss_matches_jax(seed, legacy):
    preds, targets, scaled = _batch(seed)
    for p, t, a in zip(preds, targets, scaled):
        got = tloss.yolo_loss(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(a),
                              legacy=legacy)
        want = jloss.yolo_loss(jnp.asarray(p), jnp.asarray(t), jnp.asarray(a), legacy=legacy)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.dim() == 0
            np.testing.assert_allclose(float(g), float(w), rtol=RTOL)


@pytest.mark.parametrize("seed", range(3))
def test_total_yolo_loss_matches_jax(seed):
    preds, targets, scaled = _batch(seed)
    total, comps = tloss.total_yolo_loss(
        [torch.from_numpy(p) for p in preds], [torch.from_numpy(t) for t in targets],
        torch.from_numpy(scaled))
    jtotal, jcomps = jloss.total_yolo_loss(
        [jnp.asarray(p) for p in preds], [jnp.asarray(t) for t in targets], jnp.asarray(scaled))
    assert comps.keys() == jcomps.keys()
    for k in jcomps:
        np.testing.assert_allclose(float(comps[k]), float(jcomps[k]), rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=RTOL)
    assert all(float(v) > 0 for v in comps.values())


def test_loss_of_empty_grid_is_zero_but_noobj():
    _, targets, scaled = _batch(0)
    empty = np.zeros_like(targets[0])
    p = np.random.default_rng(1).normal(size=empty.shape[:-1] + (5 + CLASSES,)).astype(np.float32)
    got = tloss.yolo_loss(torch.from_numpy(p), torch.from_numpy(empty), scaled[0])
    want = jloss.yolo_loss(jnp.asarray(p), jnp.asarray(empty), jnp.asarray(scaled[0]))
    assert float(got[0]) == float(got[1]) == float(got[3]) == 0.0
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=RTOL)
