"""Torch port: target encoding, decode and mAP against the JAX package.

The same seeded numpy inputs go through the JAX function and its port, on
the CPU in float32. Tolerances: ``assign_targets`` bit for bit, host
``calc_map`` equal, the device mAP functions and the decodes within 1e-6 of
JAX (the two sum the AP trapezoids in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_for_turbines_tpu import config as jcfg
from yolo_for_turbines_tpu.data.dataset import assign_targets as j_assign_targets
from yolo_for_turbines_tpu.ops import decode as jdecode
from yolo_for_turbines_tpu.ops import map as jmap
from yolo_for_turbines_tpu_torch import config as cfg
from yolo_for_turbines_tpu_torch.data.dataset import assign_targets
from yolo_for_turbines_tpu_torch.ops import decode as tdecode
from yolo_for_turbines_tpu_torch.ops import map as tmap

TOL = 1e-6


def _boxes(rng, n, classes):
    return [[*rng.uniform(0.0, 1.0, 2), *rng.uniform(0.01, 0.9, 2), int(rng.integers(classes))]
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("anchors", ["ANCHORS", "TURBINE_ANCHORS"])
def test_assign_targets_bit_for_bit(seed, anchors):
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, int(rng.integers(1, 40)), 5)
    boxes.append([1.0, 1.0, 0.3, 0.2, 1])  # the cx/cy == 1.0 edge
    a = cfg.anchors_array(getattr(cfg, anchors)).reshape(-1, 2)
    for grids in ((13, 26, 52), (2, 4, 8)):
        got = assign_targets(boxes, a, grids)
        want = j_assign_targets(boxes, a, grids)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def _bucketed(rng, n_img, n_cls, k, g, max_det, max_gt):
    """Per-image padded slots and the same rows flat (JAX tests' layout)."""
    preds = np.zeros((n_img, k, 6), np.float32)
    gts = np.zeros((n_img, g, 6), np.float32)
    pv = np.zeros((n_img, k), bool)
    gv = np.zeros((n_img, g), bool)
    for img in range(n_img):
        for i in range(int(rng.integers(1, max_det + 1))):
            preds[img, i] = [*rng.uniform(0.2, 0.8, 2), *rng.uniform(0.1, 0.3, 2),
                             rng.uniform(0.3, 1.0), rng.integers(n_cls)]
            pv[img, i] = True
        for i in range(int(rng.integers(1, max_gt + 1))):
            gts[img, i] = [*rng.uniform(0.2, 0.8, 2), *rng.uniform(0.1, 0.3, 2),
                           1.0, rng.integers(n_cls)]
            gv[img, i] = True
    return preds, pv, gts, gv


def _rows(slots, valid):
    return [[img, *row] for img in range(slots.shape[0]) for row in slots[img][valid[img]]]


@pytest.mark.parametrize("seed", range(3))
def test_calc_map_equal(seed):
    rng = np.random.default_rng(10 + seed)
    preds, pv, gts, gv = _bucketed(rng, 6, 3, 16, 8, 12, 5)
    p_rows, g_rows = _rows(preds, pv), _rows(gts, gv)
    for thr in (0.3, 0.5):
        for fmt in ("center", "corner"):
            assert tmap.calc_map(p_rows, g_rows, thr, fmt, 3) == jmap.calc_map(
                p_rows, g_rows, thr, fmt, 3)
    assert tmap.calc_map([], g_rows, 0.5, "center", 3) == 0.0
    assert tmap.calc_map(p_rows, [], 0.5, "center", 3) == 0.0


def test_calc_map_range_equal():
    rng = np.random.default_rng(20)
    preds, pv, gts, gv = _bucketed(rng, 5, 3, 16, 8, 10, 5)
    p_rows, g_rows = _rows(preds, pv), _rows(gts, gv)
    assert tmap.calc_map_range(p_rows, g_rows, num_classes=3) == jmap.calc_map_range(
        p_rows, g_rows, num_classes=3)


@pytest.mark.parametrize("seed", range(4))
def test_calc_map_device_batched_matches_jax(seed):
    rng = np.random.default_rng(30 + seed)
    preds, pv, gts, gv = _bucketed(rng, 7, 3, 16, 8, 14, 6)
    # a few duplicate scores across images: equal scores keep image order
    preds[1, 0, 4] = preds[0, 0, 4]
    for thr in (0.3, 0.5):
        got = tmap.calc_map_device_batched(torch.from_numpy(preds), torch.from_numpy(pv),
                                           torch.from_numpy(gts), torch.from_numpy(gv),
                                           iou_threshold=thr, num_classes=3)
        want = float(jmap.calc_map_device_batched(preds, pv, gts, gv, iou_threshold=thr,
                                                  num_classes=3))
        assert got.dim() == 0 and got.dtype == torch.float32
        assert float(got) == pytest.approx(want, abs=TOL)
        # and the host semantics
        assert float(got) == pytest.approx(
            tmap.calc_map(_rows(preds, pv), _rows(gts, gv), thr, "center", 3), abs=1e-5)


def test_calc_map_device_batched_leading_other_class():
    """The round-5 leading-slot case: class 1's detection scores highest;
    class 0's first (perfect) detection must still integrate from precision
    1, so the mAP is exactly 1.0."""
    preds = np.zeros((1, 4, 6), np.float32)
    gts = np.zeros((1, 4, 6), np.float32)
    pv = np.zeros((1, 4), bool)
    gv = np.zeros((1, 4), bool)
    gts[0, 0] = [0.3, 0.3, 0.2, 0.2, 1.0, 0]
    gts[0, 1] = [0.7, 0.7, 0.2, 0.2, 1.0, 1]
    gv[0, :2] = True
    preds[0, 0] = [0.7, 0.7, 0.2, 0.2, 0.9, 1]
    preds[0, 1] = [0.3, 0.3, 0.2, 0.2, 0.8, 0]
    pv[0, :2] = True
    got = float(tmap.calc_map_device_batched(preds, pv, gts, gv, 0.5, 2))
    want = float(jmap.calc_map_device_batched(preds, pv, gts, gv, 0.5, 2))
    assert got == want == 1.0


@pytest.mark.parametrize("seed", range(2))
def test_calc_map_device_batched_gt_replay_is_exactly_one(seed):
    rng = np.random.default_rng(40 + seed)
    _, _, gts, gv = _bucketed(rng, 6, 3, 8, 8, 1, 6)
    assert float(tmap.calc_map_device_batched(gts, gv, gts, gv, 0.5, 3)) == 1.0
    assert float(jmap.calc_map_device_batched(gts, gv, gts, gv, 0.5, 3)) == pytest.approx(
        1.0, abs=TOL)


def test_calc_map_device_batched_many_images():
    rng = np.random.default_rng(50)
    preds, pv, gts, gv = _bucketed(rng, 300, 4, 32, 16, 8, 4)
    got = float(tmap.calc_map_device_batched(preds, pv, gts, gv, 0.5, 4))
    want = float(jmap.calc_map_device_batched(preds, pv, gts, gv, iou_threshold=0.5,
                                              num_classes=4))
    assert got == pytest.approx(want, abs=TOL)
    assert 0.0 < got < 1.0


@pytest.mark.parametrize("seed", range(3))
def test_calc_map_device_flat_matches_jax(seed):
    rng = np.random.default_rng(60 + seed)
    preds, pv, gts, gv = _bucketed(rng, 4, 3, 8, 6, 6, 4)
    p_rows, g_rows = _rows(preds, pv), _rows(gts, gv)
    flat_p = np.zeros((40, 7), np.float32)
    flat_g = np.zeros((30, 7), np.float32)
    flat_p[: len(p_rows)] = p_rows
    flat_g[: len(g_rows)] = g_rows
    fpv, fgv = np.arange(40) < len(p_rows), np.arange(30) < len(g_rows)
    got = float(tmap.calc_map_device(flat_p, fpv, flat_g, fgv, 0.5, 3))
    want = float(jmap.calc_map_device(flat_p, fpv, flat_g, fgv, iou_threshold=0.5,
                                      num_classes=3))
    assert got == pytest.approx(want, abs=TOL)
    assert got == pytest.approx(tmap.calc_map(p_rows, g_rows, 0.5, "center", 3), abs=1e-5)


def test_calc_map_device_range_matches_jax():
    rng = np.random.default_rng(70)
    preds, pv, gts, gv = _bucketed(rng, 5, 3, 16, 8, 10, 5)
    got = tmap.calc_map_device_range(preds, pv, gts, gv, num_classes=3)
    want = jmap.calc_map_device_range(preds, pv, gts, gv, num_classes=3)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=TOL), k
    host = tmap.calc_map_range(_rows(preds, pv), _rows(gts, gv), num_classes=3)
    for k in host:
        assert got[k] == pytest.approx(host[k], abs=1e-5), k


def _heads(rng, b, s, c):
    return rng.normal(0, 1.5, (b, 3, s, s, 5 + c)).astype(np.float32)


@pytest.mark.parametrize("is_pred", [True, False])
@pytest.mark.parametrize("s", [2, 13])
def test_decode_scale_matches_jax(is_pred, s):
    rng = np.random.default_rng(80 + s)
    anchors = cfg.scaled_anchors_array(cfg.ANCHORS, 416)[0]
    if is_pred:
        x = _heads(rng, 2, s, 4)
    else:
        boxes = _boxes(rng, 6, 4)
        x = np.stack([assign_targets(boxes, cfg.anchors_array().reshape(-1, 2),
                                     (s, 2 * s, 4 * s))[0] for _ in range(2)])
    got = tdecode.decode_scale(torch.from_numpy(x), torch.from_numpy(anchors), s, is_pred)
    want = np.asarray(jdecode.decode_scale(jnp.asarray(x), anchors, s, is_pred))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 3 * s * s, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    lists = tdecode.cells_to_boxes(x, anchors, s, is_pred)
    np.testing.assert_allclose(np.asarray(lists), want, rtol=TOL, atol=TOL)


def test_decode_all_scales_matches_jax():
    rng = np.random.default_rng(90)
    grids = cfg.grid_sizes_for(64)
    heads = [_heads(rng, 2, s, 2) for s in grids]
    scaled = cfg.scaled_anchors_array(cfg.ANCHORS, 64)
    got = tdecode.decode_all_scales([torch.from_numpy(h) for h in heads],
                                    torch.from_numpy(scaled), grids)
    want = np.asarray(jdecode.decode_all_scales([jnp.asarray(h) for h in heads], scaled, grids))
    assert got.shape == want.shape == (2, 3 * sum(s * s for s in grids), 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(scaled, jcfg.scaled_anchors_array(jcfg.ANCHORS, 64))
