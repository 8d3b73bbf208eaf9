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


def test_bundle_reader_rejects_int8(shared, tmp_path):
    import json

    from yolo_for_turbines_tpu.serving import save_predictor

    save_predictor(shared[3], tmp_path)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    manifest["quantized_spec"] = {"t": "none"}
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(NotImplementedError, match="int8"):
        load_predictor_bundle(tmp_path, device="cpu")
