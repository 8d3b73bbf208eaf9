"""The benchmark's plain reference against the port's CPU float32 path at
a tiny size: the same weights and inputs give the same heads, boxes, loss
and SGD step."""

import json

import numpy as np
import pytest
import torch

from perfbench import drivers, traffic, weights
from perfbench.drivers import train_step
from perfbench.reference import model as ref
from perfbench.reference import postprocess as post
from perfbench.reference import train as rtrain
from perfbench.tests import tiny


@pytest.fixture(params=["leaky_relu", "mish"])
def cfg(request):
    return tiny.config("t", request.param)


def _folded(cfg):
    x = traffic.device_images(torch.Generator().manual_seed(3), 4, cfg["image_size"], "cpu")
    plan, tree = weights.folded(cfg, 11, x)
    return plan, tree, x


def _predictor(cfg, plan, tree):
    from yolo_for_turbines_tpu_torch.inference import Predictor

    return Predictor.from_folded(drivers.model_config(cfg), drivers.folded_numpy(plan, tree),
                                 device="cpu", anchors=cfg["anchors"],
                                 image_size=cfg["image_size"], compute_dtype=torch.float32)


def test_folded_heads_match_the_port(cfg):
    plan, tree, x = _folded(cfg)
    got = _predictor(cfg, plan, tree).raw_heads(x)
    want = drivers.reference_heads(plan, tree, x, cfg["activation"])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).norm() / w.norm()) < 1e-5


def test_calibrated_heads_are_not_their_biases(cfg):
    plan, tree, x = _folded(cfg)
    heads = drivers.reference_heads(plan, tree, x, cfg["activation"])
    for h in heads:
        # each channel varies over images and cells
        assert float(h.reshape(-1, h.shape[-1]).std(0).min()) > 1e-2


def test_decode_and_nms_match_the_port(cfg):
    from yolo_for_turbines_tpu_torch.ops.decode import decode_raw_all
    from yolo_for_turbines_tpu_torch.ops.nms import batched_nms

    plan, tree, x = _folded(cfg)
    heads = drivers.reference_heads(plan, tree, x, cfg["activation"])
    grids = [cfg["image_size"] // s for s in cfg["strides"]]
    scaled = torch.from_numpy(np.asarray(cfg["anchors"], np.float32)
                              * np.asarray(grids, np.float32)[:, None, None])
    rows = decode_raw_all(heads, scaled, grids, cfg["num_classes"])
    assert torch.allclose(rows, post.decode(heads, cfg["anchors"], cfg["num_classes"]),
                          rtol=1e-6, atol=1e-7)
    kept, mask = batched_nms(rows, 0.45, 0.5, 256)
    cand, keep = post.nms(rows, 0.5, 0.45, 256)
    bad, total = post.mismatch(post.kept_rows(kept, mask), post.kept_rows(cand, keep))
    assert total > 0 and bad == 0


def test_letterbox_round_trip_matches_the_port():
    from yolo_for_turbines_tpu_torch.data.augment import letterbox, unletterbox_boxes

    img = traffic.host_image(np.random.default_rng(4), 96, 54)
    lb, _ = letterbox(img, None, 64)
    assert np.array_equal(post.letterbox(img, 64), lb.astype(np.float32) / 255.0)
    rows = np.array([[0.5, 0.4, 0.2, 0.1, 0.9, 1.0], [0.1, 0.7, 0.05, 0.3, 0.6, 0.0]])
    want = unletterbox_boxes(rows.tolist(), (54, 96), (64, 64))
    assert np.allclose(post.unletterbox(rows, (54, 96), 64), want)


def test_train_step_matches_the_port():
    """Two SGD steps of the port's trainer (float32) against the
    reference's, from the same weights and batches."""
    cfg = tiny.config("t", "mish")
    mix = {**tiny.MIXES["train-tiny"], "check_steps": 2}
    d = train_step.Driver(cfg, mix, 5, "cpu")
    want = train_step.reference_steps(d, 2)
    for g, w in zip(d.first["losses"], want["losses"]):
        assert g == pytest.approx(w, rel=1e-5)
    for part in ("grads", "change"):
        for k, w in want[part].items():
            g = d.first[part][k]
            # float32 sums in two orders, through a tiny random network
            assert float((g - w).norm()) <= 1e-3 * float(w.norm()) + 1e-9, (part, k)


def test_loss_terms_match_the_port():
    from yolo_for_turbines_tpu_torch.train.loss import total_yolo_loss

    cfg = tiny.config("t", "mish")
    mix = {**tiny.MIXES["train-tiny"]}
    gen, rng = torch.Generator().manual_seed(2), np.random.default_rng(2)
    x, targets = traffic.train_batch(gen, rng, mix, cfg, "cpu")
    plan, tree = weights.trainable(cfg, 9, "cpu")
    heads = ref.train_forward(plan, tree, x, cfg["activation"], cfg["num_classes"])
    grids = np.asarray([cfg["image_size"] // s for s in cfg["strides"]], np.float32)
    anchors = torch.from_numpy(np.asarray(cfg["anchors"], np.float32) * grids[:, None, None])
    total, terms = rtrain.total_loss(heads, targets, anchors)
    ptotal, pterms = total_yolo_loss(heads, targets, anchors)
    assert float(total) == pytest.approx(float(ptotal), rel=1e-6)
    for k, v in terms.items():
        assert float(v) == pytest.approx(float(pterms[k]), rel=1e-5, abs=1e-7)


def test_sgd_step_matches_torch():
    torch.manual_seed(0)
    p = [torch.randn(5, requires_grad=True), torch.randn(3, 2, requires_grad=True)]
    q = [t.detach().clone().requires_grad_(True) for t in p]
    opt = torch.optim.SGD(q, lr=0.1, momentum=0.9, weight_decay=5e-4)
    buffers = [None, None]
    for _ in range(3):
        for a, b in zip(p, q):
            g = torch.randn_like(a)
            a.grad, b.grad = g.clone(), g.clone()
        rtrain.sgd_step(p, buffers, 0.1, 0.9, 5e-4)
        opt.step()
    for a, b in zip(p, q):
        assert torch.allclose(a, b, atol=1e-7)


def test_reference_imports_nothing_of_the_port():
    import subprocess
    import sys

    code = ("import sys; import perfbench.reference.model, perfbench.reference.postprocess, "
            "perfbench.reference.train, perfbench.weights, perfbench.traffic, perfbench.roofline; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'yolo_for_turbines_tpu_torch', 'yolo_for_turbines_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tiny.HERE.parent), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
