"""Torch port: the serving slice end to end against the JAX Predictor.

Mini model (tests/helpers.py) at 128px, B=2, float32 on the CPU, the same
folded numpy weights in both packages. Random init leaves every objectness
within about 1e-5 of a constant, where scores tie and torch.topk and
lax.top_k may order near-ties differently. So the objectness columns of each
head's final 1x1 weights are scaled up in the shared tree (the box columns
are not, so exp(w, h) stays finite), and the test asserts that consecutive
top-K scores are further apart than the two frameworks' scores differ.

Keep masks must be equal; boxes agree within atol=1e-5 (the forward sums in
a different order in the two frameworks).

The int8 tests quantize the JAX predictor, save it as a bundle and load it
in the port. The two int8 forwards use the same int8 numbers
(``qparams_from_numpy``) but different leaky_relu forms, which may move a
requant code at a .5 tie; the same spread check, equal keep masks and
atol=1e-5 apply. The bundle-loaded heads must equal the port's own int8
forward bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import mini_model
from yolo_for_turbines_tpu.inference import Predictor as JaxPredictor
from yolo_for_turbines_tpu_torch.inference import Predictor
from yolo_for_turbines_tpu_torch.serving import load_predictor_bundle

SIZE, K = 128, 256
OBJECTNESS_GAIN = 3e4


@pytest.fixture(scope="module")
def shared():
    from yolo_for_turbines_tpu.models.yolov3 import PlanHead

    model = mini_model()
    params, stats = model.init(jax.random.PRNGKey(7))
    folded = jax.tree_util.tree_map(np.asarray, model.fold(params, stats))
    for entry, p in zip(model.plan, folded):
        if isinstance(entry, PlanHead):
            w = p["conv2"]["w"].copy()
            w[..., 4 :: entry.num_classes + 5] *= OBJECTNESS_GAIN
            p["conv2"] = {"w": w, "b": p["conv2"]["b"]}
    x = np.random.default_rng(8).uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    jax_pred = JaxPredictor(model, folded, image_size=SIZE, max_boxes=K,
                            compute_dtype=jnp.float32)
    port = Predictor.from_folded(model.cfg, folded, device="cpu", image_size=SIZE,
                                 max_boxes=K)
    return model, folded, x, jax_pred, port


def _assert_same_detections(kept_t, keep_t, kept_j, keep_j):
    kept_j, keep_j = np.asarray(kept_j), np.asarray(keep_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    np.testing.assert_allclose(kept_t.numpy(), kept_j, rtol=0, atol=1e-5)


def test_scores_are_spread(shared):
    _, _, x, jax_pred, port = shared
    scores_j = np.asarray(jax_pred.predict_batch(x)[0])[..., 4]
    scores_t = port.predict_batch(x)[0].numpy()[..., 4]
    # more candidates pass the 0.5 pre-filter than K, so no -inf padding rows
    assert (scores_j > 0.5).all()
    gaps = -np.diff(scores_j, axis=1)
    assert gaps.min() > 2 * np.abs(scores_t - scores_j).max() > 0


def test_predict_batch_matches_jax(shared):
    _, _, x, jax_pred, port = shared
    kept_t, keep_t = port.predict_batch(x)
    assert kept_t.shape == (2, K, 6) and keep_t.dtype == torch.bool
    assert 0 < int(keep_t.sum()) < 2 * K
    _assert_same_detections(kept_t, keep_t, *jax_pred.predict_batch(x))


def _images():
    rng = np.random.default_rng(9)
    return [rng.integers(0, 256, (100, 160, 3), dtype=np.uint8),
            rng.integers(0, 256, (200, 120, 3), dtype=np.uint8)]


def test_predict_images_matches_jax(shared):
    _, _, _, jax_pred, port = shared
    images = _images()
    got, want = port.predict_images(images), jax_pred.predict_images(images)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=1e-5)


def test_predict_image_matches_jax(shared):
    _, _, _, jax_pred, port = shared
    image = _images()[1]
    got, want = port.predict_image(image), jax_pred.predict_image(image)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-5)


def test_bundle_reader_matches_jax(shared, tmp_path):
    from yolo_for_turbines_tpu.serving import save_predictor

    _, _, x, jax_pred, port = shared
    save_predictor(jax_pred, tmp_path)
    loaded = load_predictor_bundle(tmp_path, device="cpu")
    assert loaded.compute_dtype == torch.float32
    assert (loaded.image_size, loaded.max_boxes) == (SIZE, K)
    kept_l, keep_l = loaded.predict_batch(x)
    _assert_same_detections(kept_l, keep_l, *jax_pred.predict_batch(x))
    kept_p, keep_p = port.predict_batch(x)
    assert torch.equal(keep_l, keep_p) and torch.equal(kept_l, kept_p)


@pytest.fixture(scope="module")
def int8(shared, tmp_path_factory):
    """The JAX predictor quantized on a seeded calibration batch, saved as a
    bundle, and the port's predictor loaded from that bundle."""
    from yolo_for_turbines_tpu.serving import save_predictor

    model, folded, _, _, _ = shared
    calib = np.random.default_rng(10).uniform(size=(4, SIZE, SIZE, 3)).astype(np.float32)
    jax_q = JaxPredictor(model, folded, image_size=SIZE, max_boxes=K,
                         compute_dtype=jnp.float32).quantize(calib)
    path = tmp_path_factory.mktemp("int8_bundle")
    save_predictor(jax_q, path)
    return calib, jax_q, load_predictor_bundle(path, device="cpu")


def test_int8_scores_are_spread(shared, int8):
    x = shared[2]
    _, jax_q, loaded = int8
    scores_j = np.asarray(jax_q.predict_batch(x)[0])[..., 4]
    scores_t = loaded.predict_batch(x)[0].numpy()[..., 4]
    assert (scores_j > 0.5).all()
    gaps = -np.diff(scores_j, axis=1)
    assert gaps.min() > 2 * np.abs(scores_t - scores_j).max()


def test_int8_bundle_predict_batch_matches_jax(shared, int8):
    # the two int8 forwards may differ by a requant code where the leaky
    # forms differ by an ulp; boxes within atol=1e-5 as in the f32 tests
    x = shared[2]
    _, jax_q, loaded = int8
    kept_t, keep_t = loaded.predict_batch(x)
    assert 0 < int(keep_t.sum()) < 2 * K
    _assert_same_detections(kept_t, keep_t, *jax_q.predict_batch(x))


def test_int8_bundle_raw_heads_equal_port_forward(shared, int8):
    # the bundle reader serves exactly the port's int8 forward over
    # qparams_from_numpy of the JAX tree: bit for bit
    from yolo_for_turbines_tpu_torch.models import quantize as tq
    from yolo_for_turbines_tpu_torch.models.convert import qparams_from_numpy

    x = shared[2]
    _, jax_q, loaded = int8
    qtree = jax.tree_util.tree_map(np.asarray, jax_q._qparams)
    plan = loaded.model.plan
    want = tq.apply_inference_int8(plan, qparams_from_numpy(plan, qtree, "cpu"),
                                   torch.from_numpy(x), raw_heads=True,
                                   compute_dtype=torch.float32)
    got = loaded.raw_heads(x)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


def test_int8_quantize_matches_jax(shared, int8):
    # Predictor.quantize starts from the f32 weights: int8 codes and weight
    # scales equal JAX's bit for bit, activation scales within rtol 1e-5
    from yolo_for_turbines_tpu_torch.models.convert import qparams_from_numpy

    model, folded, _, _, _ = shared
    calib, jax_q, _ = int8
    port_q = Predictor.from_folded(model.cfg, folded, device="cpu", image_size=SIZE,
                                   max_boxes=K).quantize(calib)
    want = qparams_from_numpy(port_q.model.plan,
                              jax.tree_util.tree_map(np.asarray, jax_q._qparams), "cpu")
    got_leaves = jax.tree_util.tree_leaves(port_q._qparams["layers"])
    want_leaves = jax.tree_util.tree_leaves(want["layers"])
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and torch.equal(g, w)
    np.testing.assert_allclose(port_q._qparams["scales"].numpy(), want["scales"].numpy(),
                               rtol=1e-5, atol=0)


def test_from_folded_holds_the_callers_tree(shared):
    # quantize() starts from the tree from_folded was given, held, not copied
    model, folded, _, _, _ = shared
    pred = Predictor.from_folded(model.cfg, folded, device="cpu", image_size=SIZE)
    assert pred._folded_input is folded


def test_quantize_from_an_f32_module_matches_from_folded(shared, int8):
    # a predictor built from a module has no tree; with f32 compute its
    # module keeps the f32 weights, and quantize() reads them from there
    from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy
    from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan

    model, folded, _, _, _ = shared
    calib = int8[0]
    module = folded_from_numpy(build_plan(model.cfg), folded, model.cfg)
    got = Predictor(module, device="cpu", image_size=SIZE).quantize(calib)._qparams
    want = Predictor.from_folded(model.cfg, folded, device="cpu",
                                 image_size=SIZE).quantize(calib)._qparams
    got_leaves = jax.tree_util.tree_leaves(got)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_quantize_refuses_a_cast_module(shared):
    # bf16 compute rounds the module's weights: without the f32 tree,
    # quantize() raises rather than calibrate from rounded weights
    from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy
    from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan

    model, folded, x, _, _ = shared
    module = folded_from_numpy(build_plan(model.cfg), folded, model.cfg)
    pred = Predictor(module, device="cpu", image_size=SIZE, compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="full-precision"):
        pred.quantize(x)


def _rows_in_order(boxes):
    """Rows sorted by every column, each rounded to 1e-4 (far above the two
    forwards' differences): letterbox padding gives equal scores in several
    cells, and the two int8 forwards may order such ties apart."""
    a = np.asarray(boxes)
    return a[np.lexsort(np.round(a, 4).T[::-1])]


def test_int8_predict_images_matches_jax(int8):
    _, jax_q, loaded = int8
    images = _images()
    got, want = loaded.predict_images(images), jax_q.predict_images(images)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        np.testing.assert_allclose(_rows_in_order(g), _rows_in_order(w), rtol=0, atol=1e-5)


def test_int8_predict_image_matches_jax(int8):
    _, jax_q, loaded = int8
    image = _images()[0]
    got, want = loaded.predict_image(image), jax_q.predict_image(image)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(_rows_in_order(got), _rows_in_order(want), rtol=0, atol=1e-5)
