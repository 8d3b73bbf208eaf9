"""Torch port: serving the CSPDarknet-53 and YOLOv3-tiny families against
the JAX package: the Predictor in f32 and int8, bundles written by the JAX
``save_predictor`` (bf16 and int8), the darknet weight reader and
``load_predictor``, and ``load_predictor_from_checkpoint``.

The mini CSP model and tiny with 2 classes at 128px, B = 2, on the CPU. As
in tests/test_torch_predictor.py, the objectness columns of each head's
last 1x1 are scaled and shifted in the shared tree so that scores are distinct
(random init ties them: logits of mean -3 and deviation 2 on the test
batch, over calibrated BN statistics), and every comparison asserts that consecutive
top-K scores lie further apart than the two packages' scores differ. Keep
masks must be equal and boxes within atol=1e-5. Tiny at 128px has 240
candidates, fewer than K = 256: both packages take min(K, N).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import MINI_CSP_LAYERS, MINI_LAYERS
from torch_eval_weights import eval_weights
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu import config as jcfg
from yolo_for_turbines_tpu.config import ModelConfig as JaxModelConfig
from yolo_for_turbines_tpu.inference import Predictor as JaxPredictor
from yolo_for_turbines_tpu.models import darknet_weights as jdw
from yolo_for_turbines_tpu.models import yolov3 as jyolo
from yolo_for_turbines_tpu_torch import config as cfg
from yolo_for_turbines_tpu_torch.inference import (
    Predictor,
    load_predictor,
    load_predictor_from_checkpoint,
)
from yolo_for_turbines_tpu_torch.models import darknet_weights as tdw
from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan
from yolo_for_turbines_tpu_torch.serving import load_predictor_bundle

SIZE, K = 128, 256
# detections, every column: the mini CSP model turns a 1e-6 relative change
# of its input into 2e-4 at its heads (the mini Darknet-53 into 3e-5), and
# its f32 survivors differ by up to 1.5e-4 between the packages (this CPU)
ATOL = {"csp": 3e-4, "tiny": 1e-5}
OBJECTNESS_MEAN, OBJECTNESS_STD = -3.0, 2.0
FAMILIES = {
    "csp": (dict(num_classes=2, layer_config=MINI_CSP_LAYERS), cfg.ANCHORS),
    "tiny": (dict(num_classes=2, backbone="yolov3_tiny", strides=(32, 16)), cfg.TINY_ANCHORS),
}


def _spread(model, trees, x):
    """Scale and shift each anchor's objectness column of each head's last
    1x1, in place in every tree of ``trees`` (a folded tree first: its
    forward on ``x`` sets the gains), so that those logits have mean
    OBJECTNESS_MEAN and standard deviation OBJECTNESS_STD on ``x``: few
    enough pass the 0.5 threshold that their scores lie apart."""
    heads = iter(jyolo.apply_inference(model.plan, trees[0], jnp.asarray(x),
                                       activation=model.cfg.activation,
                                       compute_dtype=jnp.float32, raw_heads=True))
    for i, entry in enumerate(model.plan):
        if not isinstance(entry, jyolo.PlanHead):
            continue
        y = np.asarray(next(heads), np.float64)
        conv = trees[0][i]["conv2"]
        w, b = np.array(conv["w"], np.float32), np.array(conv["b"], np.float32)
        for a in range(entry.anchors_per_scale):
            row = a * (entry.num_classes + 5) + 4
            free = y[..., row] - b[row]
            gain = OBJECTNESS_STD / free.std()
            w[..., row] *= gain
            b[row] = OBJECTNESS_MEAN - gain * free.mean()
        for tree in trees:
            tree[i]["conv2"] = dict(tree[i]["conv2"], w=w, b=b)


@pytest.fixture(scope="module", params=list(FAMILIES))
def shared(request):
    kw, anchors = FAMILIES[request.param]
    # calibrated BN statistics: at their init the CSP heads are constant
    model, params, stats = eval_weights(seed=7, size=SIZE,
                                        model=jyolo.YOLOv3(JaxModelConfig(**kw)))
    folded = jax.tree_util.tree_map(np.asarray, model.fold(params, stats))
    x = np.random.default_rng(8).uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    _spread(model, (folded, params), x)
    jax_pred = JaxPredictor(model, folded, anchors=anchors, image_size=SIZE, max_boxes=K,
                            compute_dtype=jnp.float32)
    port = Predictor.from_folded(model.cfg, folded, device="cpu", anchors=anchors,
                                 image_size=SIZE, max_boxes=K)
    return request.param, model, params, stats, folded, x, jax_pred, port


def _assert_same_rows(got, want, atol):
    """Two sets of detection rows, matched one to one: each row of ``got``
    within ``atol`` (every column) of its own row of ``want``. Survivors
    whose scores lie closer than the two packages' differences may come out
    in either order, so rows are matched, not compared in place."""
    got, want = np.asarray(got, np.float64).reshape(-1, 6), np.asarray(want, np.float64).reshape(-1, 6)
    assert len(got) == len(want) > 0
    dist = np.abs(got[:, None, :] - want[None, :, :]).max(-1)
    match = dist.argmin(1)
    assert sorted(match) == list(range(len(want)))
    assert dist[np.arange(len(got)), match].max() <= atol


def _assert_same_detections(got, want, family):
    """The same survivors per image, with distinct scores."""
    (kept_t, keep_t), (kept_j, keep_j) = got, want
    kept_t, keep_t = kept_t.numpy(), keep_t.numpy()
    kept_j, keep_j = np.asarray(kept_j), np.asarray(keep_j)
    assert kept_t.shape == kept_j.shape
    for b in range(len(kept_j)):
        rows = kept_j[b][keep_j[b]]
        assert len(np.unique(rows[:, 4])) == len(rows)
        _assert_same_rows(kept_t[b][keep_t[b]], rows, ATOL[family])


def test_predict_batch_matches_jax(shared):
    family, _, _, _, _, x, jax_pred, port = shared
    got, want = port.predict_batch(x), jax_pred.predict_batch(x)
    n_cand = 3 * (4 ** 2 + 8 ** 2) if family == "tiny" else K
    assert tuple(got[0].shape) == np.asarray(want[0]).shape == (2, n_cand, 6)
    _assert_same_detections(got, want, family)


def _images():
    rng = np.random.default_rng(9)
    return [rng.integers(0, 256, (100, 160, 3), dtype=np.uint8),
            rng.integers(0, 256, (200, 120, 3), dtype=np.uint8)]


def test_predict_images_and_image_match_jax(shared):
    family, _, _, _, _, _, jax_pred, port = shared
    images = _images()
    got, want = port.predict_images(images), jax_pred.predict_images(images)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_same_rows(g, w, ATOL[family])
    _assert_same_rows(port.predict_image(images[1]), jax_pred.predict_image(images[1]),
                      ATOL[family])


def _jax_int8_detections(jax_q, x):
    """The JAX int8 Predictor's pipeline with its int8 forward run op by op
    (decode and NMS compiled as the Predictor compiles them). Compiled by
    XLA, that forward rounds its f32 epilogue otherwise than op by op, and a
    code flipped at a .5 tie moves the mini CSP model's int8 logits by up to
    2.9 (measured); the port's int8 forward is within 5e-6 of the op-by-op
    one."""
    from yolo_for_turbines_tpu.models import quantize as jq
    from yolo_for_turbines_tpu.ops.decode import decode_raw_all
    from yolo_for_turbines_tpu.ops.nms import batched_nms

    raw = jq.apply_inference_int8(jax_q.model.plan, jax_q._qparams, x,
                                  activation=jax_q.model.cfg.activation, raw_heads=True,
                                  compute_dtype=jax_q.compute_dtype, portable=True)
    grid_sizes = jcfg.grid_sizes_for(x.shape[1], jax_q.model.strides)
    anchors = jnp.asarray(jax_q.anchors) * jnp.asarray(grid_sizes, jnp.float32).reshape(-1, 1, 1)

    @jax.jit
    def pipeline(raw):
        boxes = decode_raw_all(raw, anchors, grid_sizes, jax_q.model.cfg.num_classes)
        return batched_nms(boxes, iou_threshold=jax_q.nms_iou_threshold,
                           obj_threshold=jax_q.conf_threshold, max_boxes=jax_q.max_boxes)

    return pipeline(raw)


@pytest.fixture(scope="module")
def int8(shared, tmp_path_factory):
    """The JAX predictor quantized on a seeded batch and saved as a bundle,
    and the port's predictor read from it."""
    from yolo_for_turbines_tpu.serving import save_predictor

    family, model, _, _, folded, _, _, _ = shared
    calib = np.random.default_rng(10).uniform(size=(4, SIZE, SIZE, 3)).astype(np.float32)
    jax_q = JaxPredictor(model, folded, anchors=FAMILIES[family][1], image_size=SIZE,
                         max_boxes=K, compute_dtype=jnp.float32).quantize(calib)
    path = tmp_path_factory.mktemp(f"int8_{family}")
    save_predictor(jax_q, path)
    return calib, jax_q, load_predictor_bundle(path, device="cpu")


def test_int8_bundle_matches_jax(shared, int8):
    x = shared[5]
    _, jax_q, loaded = int8
    assert loaded._qparams is not None and loaded.compute_dtype == torch.float32
    _assert_same_detections(loaded.predict_batch(x), _jax_int8_detections(jax_q, x), shared[0])


def test_int8_bundle_serves_the_port_forward(shared, int8):
    # bit for bit the port's int8 forward over qparams_from_numpy of the
    # JAX tree
    from yolo_for_turbines_tpu_torch.models import quantize as tq
    from yolo_for_turbines_tpu_torch.models.convert import qparams_from_numpy

    x = shared[5]
    _, jax_q, loaded = int8
    plan = loaded.model.plan
    qtree = jax.tree_util.tree_map(np.asarray, jax_q._qparams)
    want = tq.apply_inference_int8(plan, qparams_from_numpy(plan, qtree, "cpu"),
                                   torch.from_numpy(x), activation=loaded.model.cfg.activation,
                                   raw_heads=True, compute_dtype=torch.float32)
    got = loaded.raw_heads(x)
    assert len(got) == len(want) == len(loaded.model.strides)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_int8_quantize_matches_jax(shared, int8):
    # Predictor.quantize from the f32 tree: codes equal, scales within the
    # calibration gate of tests/test_torch_families_int8.py (scales that
    # differ in the last bits may move a code at a .5 tie, so the two
    # quantized predictors are not held to the same detections)
    from yolo_for_turbines_tpu_torch.models.convert import qparams_from_numpy

    family, model, _, _, folded, _, _, _ = shared
    calib, jax_q, _ = int8
    port_q = Predictor.from_folded(model.cfg, folded, device="cpu", anchors=FAMILIES[family][1],
                                   image_size=SIZE, max_boxes=K).quantize(calib)
    want = qparams_from_numpy(port_q.model.plan,
                              jax.tree_util.tree_map(np.asarray, jax_q._qparams), "cpu")
    for g, w in zip(jax.tree_util.tree_leaves(port_q._qparams["layers"]),
                    jax.tree_util.tree_leaves(want["layers"])):
        assert g.dtype == w.dtype and torch.equal(g, w)
    np.testing.assert_allclose(port_q._qparams["scales"].numpy(), want["scales"].numpy(),
                               rtol=5e-5, atol=0)


def test_bf16_bundle_reads_as_the_port_builds_it(shared, tmp_path):
    # a bf16 bundle: the tree comes back exactly, the predictor computes in
    # bf16, and it serves what the port's own bf16 predictor of that tree
    # serves, bit for bit
    from yolo_for_turbines_tpu.serving import save_predictor

    family, model, _, _, folded, x, _, _ = shared
    anchors = FAMILIES[family][1]
    jax_bf16 = JaxPredictor(model, folded, anchors=anchors, image_size=SIZE, max_boxes=K)
    save_predictor(jax_bf16, tmp_path)
    loaded = load_predictor_bundle(tmp_path, device="cpu")
    assert loaded.compute_dtype == torch.bfloat16
    assert loaded.model.cfg.backbone == model.cfg.backbone
    assert loaded.model.strides == tuple(model.cfg.strides)
    for a, b in zip(jax.tree_util.tree_leaves(loaded._folded_input),
                    jax.tree_util.tree_leaves(folded)):
        np.testing.assert_array_equal(np.asarray(a), b)
    port = Predictor.from_folded(model.cfg, folded, device="cpu", anchors=anchors,
                                 image_size=SIZE, max_boxes=K, compute_dtype=torch.bfloat16)
    (kl, ml), (kp, mp) = loaded.predict_batch(x), port.predict_batch(x)
    assert torch.equal(kl, kp) and torch.equal(ml, mp)


# ---------------------------------------------------------------------------
# darknet weights and load_predictor
# ---------------------------------------------------------------------------


def _trees(model, seed):
    """Seeded ``(params, batch_stats)`` numpy trees of a JAX model handle,
    made by the port's module (the JAX ``init`` takes tens of seconds op by
    op on this CPU), with BN statistics off their init."""
    from yolo_for_turbines_tpu_torch.models.convert import trainable_to_numpy
    from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3

    params, stats = trainable_to_numpy(
        YOLOv3(model.cfg, generator=torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.0, 0.3, a.shape).astype(np.float32), stats)
    return params, stats


def test_tiny_weight_file_size():
    plan = build_plan(cfg.ModelConfig(backbone="yolov3_tiny", strides=(32, 16)))
    assert tdw.expected_num_floats(plan) == 8_858_734
    want = jyolo.YOLOv3(JaxModelConfig(backbone="yolov3_tiny", strides=(32, 16))).plan
    assert jdw.expected_num_floats(want) == 8_858_734


def test_csp_counts_and_export_match_jax(tmp_path):
    model = jyolo.YOLOv3(JaxModelConfig(num_classes=2, layer_config=MINI_CSP_LAYERS))
    plan = build_plan(model.cfg)
    assert tdw.expected_num_floats(plan) == jdw.expected_num_floats(model.plan) > 0
    params, stats = _trees(model, 0)
    with pytest.raises(ValueError, match="PlanCSP"):
        tdw.export_darknet_weights(plan, params, stats, str(tmp_path / "csp.weights"))
    with pytest.raises(ValueError, match="PlanCSP"):
        jdw.export_darknet_weights(model.plan, params, stats, str(tmp_path / "csp.weights"))


@pytest.mark.parametrize("freeze", [False, True])
def test_csp_darknet_load_matches_jax(tmp_path, freeze):
    # a Darknet-53 file read by a CSP plan: CSP stages read nothing and keep
    # the given weights, later layers read at the offsets the JAX reader
    # uses
    dark = jyolo.YOLOv3(JaxModelConfig(num_classes=2, layer_config=MINI_LAYERS))
    path = tmp_path / "mini.weights"
    jdw.export_darknet_weights(dark.plan, *_trees(dark, 1), str(path))
    csp = jyolo.YOLOv3(JaxModelConfig(num_classes=2, layer_config=MINI_CSP_LAYERS))
    params, stats = _trees(csp, 2)
    want = jdw.load_darknet_weights(str(path), csp.plan, params, stats, freeze=freeze)
    got = tdw.load_darknet_weights(str(path), build_plan(csp.cfg), params, stats,
                                   freeze=freeze)
    assert got[3] == want[3] == tdw.expected_num_floats(build_plan(csp.cfg))
    for g, w in zip(got[:3], want[:3]):
        assert jax.tree_util.tree_structure(g) == jax.tree_util.tree_structure(w)
        for a, b in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(w)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    csp_entries = [i for i, e in enumerate(csp.plan) if type(e).__name__ == "PlanCSP"]
    for i in csp_entries:
        assert not any(jax.tree_util.tree_leaves(got[2][i]))
        for a, b in zip(jax.tree_util.tree_leaves(got[0][i]),
                        jax.tree_util.tree_leaves(params[i])):
            np.testing.assert_array_equal(a, b)
    assert any(jax.tree_util.tree_leaves(got[2])) == freeze


def test_csp_darknet_load_into_the_module(tmp_path):
    from yolo_for_turbines_tpu_torch.models.convert import trainable_to_numpy
    from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3

    dark = jyolo.YOLOv3(JaxModelConfig(num_classes=2, layer_config=MINI_LAYERS))
    path = tmp_path / "mini.weights"
    jdw.export_darknet_weights(dark.plan, *_trees(dark, 1), str(path))
    port = YOLOv3(cfg.ModelConfig(num_classes=2, layer_config=MINI_CSP_LAYERS),
                  generator=torch.Generator().manual_seed(0))
    before = trainable_to_numpy(port)
    names, consumed = tdw.load_darknet_into(str(path), port, freeze=True)
    assert consumed == tdw.expected_num_floats(port.plan)
    csp_layers = {f"layers.{i}." for i, e in enumerate(port.plan) if type(e).__name__ == "PlanCSP"}
    assert names and not any(n.startswith(tuple(csp_layers)) for n in names)
    want = tdw.load_darknet_weights(str(path), port.plan, *before)
    for a, b in zip(jax.tree_util.tree_leaves(trainable_to_numpy(port)),
                    jax.tree_util.tree_leaves(want[:2])):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def tiny_file(tmp_path_factory):
    """A tiny darknet file written by the JAX exporter, objectness spread."""
    model = jyolo.YOLOv3(JaxModelConfig(num_classes=2, backbone="yolov3_tiny",
                                        strides=(32, 16)))
    _, params, stats = eval_weights(seed=11, size=SIZE, model=model)
    folded = jax.tree_util.tree_map(np.asarray, model.fold(params, stats))
    x = np.random.default_rng(12).uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    _spread(model, (folded, params), x)
    path = tmp_path_factory.mktemp("tiny") / "yolov3-tiny.weights"
    jdw.export_darknet_weights(model.plan, params, stats, str(path))
    return model, path


def test_load_predictor_matches_jax(tiny_file):
    from yolo_for_turbines_tpu.inference import load_predictor as jax_load_predictor

    model, path = tiny_file
    kw = dict(num_classes=2, anchors=cfg.TINY_ANCHORS, image_size=SIZE, backbone="yolov3_tiny")
    port = load_predictor(path, device="cpu", **kw)
    assert port.model.strides == (32, 16) and port.device.type == "cpu"
    # the JAX loader's steps, in f32 (its predictor casts to bf16)
    params, stats = _trees(model, 0)  # every layer is read: the init does not matter
    params, stats, _, _ = jdw.load_darknet_weights(str(path), model.plan, params, stats)
    folded = jax.tree_util.tree_map(np.asarray, model.fold(params, stats))
    for a, b in zip(jax.tree_util.tree_leaves(port._folded_input),
                    jax.tree_util.tree_leaves(folded)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    jax_f32 = JaxPredictor(model, folded, anchors=cfg.TINY_ANCHORS, image_size=SIZE,
                           compute_dtype=jnp.float32)
    x = np.random.default_rng(12).uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    _assert_same_detections(port.predict_batch(x), jax_f32.predict_batch(x), "tiny")
    # and the JAX load_predictor's own (bf16) weights are these, rounded
    jax_pred = jax_load_predictor(str(path), **kw)
    for a, b in zip(jax.tree_util.tree_leaves(jax_pred.folded_params),
                    jax.tree_util.tree_leaves(port._folded_input)):
        np.testing.assert_allclose(np.asarray(a, np.float32), b, rtol=2 ** -8, atol=0)


def test_loaders_need_a_card_unless_asked(tiny_file, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, path = tiny_file
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_predictor(path, num_classes=2, backbone="yolov3_tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_predictor_from_checkpoint(tmp_path / "none.ckpt")


@pytest.mark.parametrize("backbone,kw", [
    ("yolov3_tiny", dict(anchors=cfg.TINY_ANCHORS)),
    ("cspdarknet53", dict()),
])
def test_load_predictor_from_checkpoint_round_trip(tmp_path, backbone, kw):
    # a trained state's checkpoint (the port's format) served: the same
    # detections as Predictor.from_folded on that state's fold()
    from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3
    from yolo_for_turbines_tpu_torch.train.checkpoint import save_checkpoint
    from yolo_for_turbines_tpu_torch.train.steps import create_train_state

    model_cfg = cfg.ModelConfig(num_classes=2, activation="mish", backbone=backbone,
                                strides=cfg.strides_for(backbone))
    model = YOLOv3(model_cfg, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():  # running statistics away from their init
        model.train()(torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(4)))
    state = create_train_state(model, cfg.TrainConfig())
    save_checkpoint(state, tmp_path / "best.ckpt")
    pred = load_predictor_from_checkpoint(tmp_path / "best.ckpt", backbone=backbone,
                                          image_size=64, device="cpu", **kw)
    want = Predictor.from_folded(model_cfg, model.eval().fold(), device="cpu", image_size=64,
                                 anchors=kw.get("anchors", cfg.TURBINE_ANCHORS))
    for a, b in zip(jax.tree_util.tree_leaves(pred._folded_input),
                    jax.tree_util.tree_leaves(want._folded_input)):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(5).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    (kp, mp), (kw_, mw) = pred.predict_batch(x), want.predict_batch(x)
    assert torch.equal(kp, kw_) and torch.equal(mp, mw)
    with pytest.raises(RuntimeError):  # another backbone's module refuses the state
        load_predictor_from_checkpoint(
            tmp_path / "best.ckpt", device="cpu",
            backbone="darknet53" if backbone == "yolov3_tiny" else "yolov3_tiny")
